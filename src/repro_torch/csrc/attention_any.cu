// Any-dims attention for Hopper (sm_90a): the variant of kernel K2
// (flash_attention) that takes every head dim its JAX wrapper takes.
//
// Replaces, at the head dims the tiled kernel is not instantiated for, the
// Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel, whose wrapper pads D to the 128 lanes and so
// takes any head dim.  The wrapper (kernels/flash_attention/ops.py) sends
// here bf16 past head dim 256 and f32 past 128, under every mask mode and
// q_offset, chosen from the dims before the launch; the launches count
// under flash_attention.  (K4's any-dims forms are decode_any.cu.)
//
// Bound on an H100: operations (4 Sq Sk D H FLOPs over the visible pairs)
// at prefill sizes: [4, 500, 8, 512] causal is 8.2 GFLOP against ~6 MB.
// The first port ran both products as scalar f32 FMAs on the CUDA cores,
// restaged each key tile for every 16 query rows and kept its accumulators
// in shared memory (past D 2048 in a device-memory workspace): 1.8-2x
// slower than one SDPA call at the measured shapes.
//
// Design (the tiled K2's layout, flash_attention.cu, at any D):
// - a block is kWarps = 4 warps, one per 16 query rows, which share every
//   staged key tile of kKeys keys; grid (row tiles, B * H, head-dim
//   passes);
// - both products on the tensor cores: bf16 operands on mma.sync
//   m16n8k16 with f32 accumulation, P entering P V as bf16 hi + lo (one
//   bf16 rounding of P would cost ~2^-9 of a weight); f32 operands on
//   mma.sync m16n8k8 TF32 as split hi + lo (three products, any_mma.cuh),
//   P split likewise, its C fragment used as the A fragment with the keys
//   of an 8-key step permuted (column t is key 2t, column t + 4 key 2t + 1;
//   V's B fragment reads the same keys), so P never leaves registers;
// - S = Q K^T accumulates over the head dim in slices of kRowBytes bytes
//   (128 bf16 / 64 f32 columns): each slice of a tile's K rows is one
//   stage of a shared-memory ring filled by cp.async a stage or two ahead;
//   then the pass's V columns, a slice a stage.  The ring runs on across
//   key tiles, so the next tile's first slices load while this one
//   finishes.  The block's Q rows stay in shared memory for the call where
//   they fit beside a kSlotsQ-slot ring in kSmemBlock bytes, two blocks an
//   SM (bf16 D <= 512, f32 D <= 256); past that each K slice restages the
//   same slice of Q with it, in a kSlots-slot ring;
// - head-dim passes instead of a workspace: a warp's [16, W] f32 output
//   takes W / 2 registers a thread, so the output columns split into
//   passes of at most kPass columns (the grid's third dimension); each
//   pass recomputes the scores.  The pass count is ceil(D / kPass), its
//   width ceil(D / passes) rounded up to 16: a function of D alone, decided
//   here (attention_any_plan reports it).  No head dim is refused;
// - the mask's dead key ranges are loop bounds (the TPU kernel's block
//   skipping), a warp skips a tile none of its rows sees, and the
//   per-element mask runs only in tiles that straddle a mask edge;
// - ragged dims: a head dim that is not a multiple of 16, or rows off
//   16-byte boundaries, stage by 8- or 4-byte cp.async with zero fill (or
//   element copies); columns past D and keys past a tile's end are zeros.
// Invariants: keys in a fixed order, each row finished by one warp, no
// atomics: two calls agree bitwise; a masked key's weight is an exact 0
// and a fully masked row gives zeros; one launch a call.
#include <type_traits>

#include "any_mma.cuh"
#include "attention_common.cuh"
#include "attention_mask.cuh"

namespace flame {
namespace any_attn {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;      // a block: 16 query rows a warp
constexpr int kKeys = 64;      // keys a tile
constexpr int kSlots = 3;      // ring slots (Q restaged with each K slice)
constexpr int kSlotsQ = 2;     // ring slots where Q stays in shared memory
constexpr int kSmemBlock = 115712;  // shared bytes a block: 2 an SM
constexpr int kRowBytes = 256; // head-dim bytes a stage holds of a row
constexpr int kPass = 256;     // output columns a head-dim pass, at most
constexpr int kMinBlocks = 2;  // blocks an SM, at least (registers)
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;
static_assert(kKeys % 16 == 0 && kPass % (kRowBytes / 2) == 0 &&
                  kRowBytes % 64 == 0,
              "key tiles of 16, passes of whole bf16 slices");

template <typename T>
struct Cfg {
  static constexpr int DS = kRowBytes / (int)sizeof(T);  // columns a stage
  static constexpr int LD = DS + 16 / (int)sizeof(T);    // row pitch
  static constexpr int CH = 16 / (int)sizeof(T);         // a 16-byte copy
  static constexpr int KSLOT = kKeys * LD;               // K or V rows
  static constexpr int SLOT = (kKeys + kRows) * LD;      // ... and Q's
};

// The launch's geometry, a function of D and the dtype alone: head-dim
// passes and their width; whether the block's Q rows stay in shared
// memory for the whole call (pitch QLD, the ring then kSlotsQ slots of K or
// V rows) or are restaged with every K slice (kSlots slots of K and Q
// rows): they stay where both fit in kSmemBlock bytes.
struct Geo {
  int passes, width, qres, QLD, slots, slot, bytes;
};
template <typename T>
__host__ __device__ inline Geo geometry(int D) {
  using C = Cfg<T>;
  constexpr int es = (int)sizeof(T);
  Geo g;
  g.passes = (D + kPass - 1) / kPass;
  g.width = ((D + g.passes - 1) / g.passes + 15) / 16 * 16;
  g.QLD = (D + C::DS - 1) / C::DS * C::DS + 16 / es;
  const long long qres_bytes =
      ((long long)kRows * g.QLD + kSlotsQ * C::KSLOT) * es;
  g.qres = qres_bytes <= kSmemBlock;
  g.slots = g.qres ? kSlotsQ : kSlots;
  g.slot = g.qres ? C::KSLOT : C::SLOT;
  g.bytes = g.qres ? (int)qres_bytes : kSlots * C::SLOT * es;
  return g;
}

struct Job {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk, D;
  Geo geo;
  Strides qs, ks, vs, os;
  int mode, window, n_history, q_offset;
  float scale;
};

// `rows` rows of DS columns from column d0 (row r at src + r * stride)
// into shared rows of pitch ld; a row at or past `live`, or a column past
// D, is zero-filled.  Where every row of the slice is whole and on 16-byte
// boundaries (the common case), a thread copies one 16-byte column chunk
// of every (kThreads / 16)-th row; else 16-byte cp.async where the address
// allows, 8- or 4-byte cp.async with zero fill, or (bf16 rows on odd
// elements) element copies.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, int rows,
                                           const T* src, long long stride,
                                           int live, int d0, int D) {
  using C = Cfg<T>;
  constexpr int per = C::DS / C::CH;  // 16-byte chunks a row
  static_assert(kThreads % per == 0, "a thread keeps its column chunk");
  if (d0 + C::DS <= D && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      ((stride * (long long)sizeof(T)) & 15) == 0) {
    constexpr int step = kThreads / per;
    const int c = (threadIdx.x % per) * C::CH;
    int r = threadIdx.x / per;
    const T* s = src + r * stride + d0 + c;
    T* d = dst + r * ld + c;
    for (; r < rows; r += step, s += step * stride, d += step * ld) {
      if (r < live)
        mma::cp_async16(d, s);
      else
        mma::cp_async16_zfill(d, src, false);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * C::CH;
    T* d = dst + r * ld + c;
    const int n = r < live ? min(C::CH, D - d0 - c) : 0;
    if (n <= 0) {
      mma::cp_async16_zfill(d, src, false);
      continue;
    }
    const T* s = src + r * stride + d0 + c;
    const uintptr_t a = reinterpret_cast<uintptr_t>(s);
    if (n == C::CH && (a & 15) == 0) {
      mma::cp_async16(d, s);
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        anymma::cp_async_zfill_n<4>(d + e, e < n ? s + e : src,
                                    e < n ? 4 : 0);
    } else if ((a & 7) == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int nb = 2 * max(0, min(4, n - 4 * p));
        anymma::cp_async_zfill_n<8>(d + 4 * p, nb ? s + 4 * p : src, nb);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = e < n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// S[16, kKeys] += Q K^T over one staged slice of `dn` live columns: q the
// warp's 16 Q rows (pitch qld), k the tile's kKeys K rows (pitch LD).
// FULL: the whole slice is live (no bound checks, so the loads can be
// hoisted).
template <typename T, bool FULL>
__device__ __forceinline__ void scores(float (*s)[4], const T* q, int qld,
                                       const T* k, int dn, int lane) {
  constexpr int LD = Cfg<T>::LD, DS = Cfg<T>::DS;
  constexpr int NS = kKeys / 8;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int kk = 0; kk < DS; kk += 8) {
      if (!FULL && kk >= dn) break;
      const float a[4] = {q[g * qld + kk + t], q[(g + 8) * qld + kk + t],
                          q[g * qld + kk + t + 4],
                          q[(g + 8) * qld + kk + t + 4]};
      unsigned ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
        const float* kr = k + (jn * 8 + g) * LD + kk;
        const float b[2] = {kr[t], kr[t + 4]};
        anymma::mma_split_b(s[jn], ah, al, b);
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < DS; kk += 16) {
      if (!FULL && kk >= dn) break;
      unsigned qa[4];
      mma::load_a_x4(qa, q, qld, 0, kk, lane);
#pragma unroll
      for (int jn = 0; jn < NS; jn += 2) {
        unsigned kb[4];
        mma::load_b_rows_x4(kb, k, LD, jn * 8, kk, lane);
        mma::mma_bf16(s[jn], qa, kb);
        mma::mma_bf16(s[jn + 1], qa, kb + 2);
      }
    }
  }
}

// acc[n tiles of this slice] += P V over one staged V slice (kKeys rows,
// the first `n` keys live; output columns [c0, c0 + DS) of the pass, those
// past `cols` skipped).  P is the scores' f32 C fragments.  FULL: every
// key and column of the slice is live (no bound checks).
template <typename T, int NO, bool FULL>
__device__ __forceinline__ void pv(float (*acc)[4], const float (*p)[4],
                                   const T* v, int n, int c0, int cols,
                                   int lane) {
  constexpr int LD = Cfg<T>::LD, DS = Cfg<T>::DS;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      if (FULL || kk * 8 < n) {
        // A: column t is key 2t of the step, column t + 4 key 2t + 1
        const float a[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
        const float* vr = v + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int jn = 0; jn < DS / 8; ++jn) {
          if (FULL || c0 + jn * 8 < cols) {
            const float b[2] = {vr[jn * 8], vr[LD + jn * 8]};
            anymma::mma_split_b(acc[jn], ah, al, b);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      if (FULL || kk * 16 < n) {
        unsigned ah[4], al[4];
        mma::split2(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
        mma::split2(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
        mma::split2(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
        mma::split2(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jp = 0; jp < DS / 16; ++jp) {
          if (FULL || c0 + jp * 16 < cols) {
            unsigned bv[4];
            mma::load_b_trans_x4(bv, v, LD, kk * 16, jp * 16, lane);
            mma::mma_bf16(acc[2 * jp], ah, bv);
            mma::mma_bf16(acc[2 * jp + 1], ah, bv + 2);
            mma::mma_bf16(acc[2 * jp], al, bv);
            mma::mma_bf16(acc[2 * jp + 1], al, bv + 2);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attention_any_kernel(Job j) {
  using C = Cfg<T>;
  constexpr int DS = C::DS, LD = C::LD;
  constexpr int NS = kKeys / 8;                // score n tiles
  constexpr int NO = kPass / 8;                // output n tiles a pass
  constexpr int MAXV = (kPass + DS - 1) / DS;  // V slices a pass, at most
  extern __shared__ __align__(128) unsigned char sm_raw[];
  const Geo& geo = j.geo;
  // [Q rows, where they stay][the ring]
  T* qbuf = reinterpret_cast<T*>(sm_raw);
  T* ring = qbuf + (geo.qres ? kRows * geo.QLD : 0);
  const int slots = geo.slots, slot = geo.slot;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / j.H, h = blockIdx.y - b * j.H;
  const int kvh = h / (j.H / j.Hkv);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, j.Sq);
  const int w0 = r0 + warp * 16;  // this warp's first row
  const bool warp_live = w0 < j.Sq;
  const int A0 = w0 + j.q_offset;                    // absolute positions
  const int A1 = min(w0 + 15, j.Sq - 1) + j.q_offset;  // of its live rows
  const int col0 = blockIdx.z * geo.width;
  const int cols = min(geo.width, j.D - col0);  // this pass's output columns
  const int mode = j.mode;
  // exp(s scale) = 2^(s scale2)
  const float scale2 = j.scale * 1.4426950408889634f;

  // key ranges [lo, hi) the block's rows can see
  int lo0 = 0, hi0 = j.Sk, lo1 = 0, hi1 = 0;
  const int diag = min(j.Sk, j.q_offset + r1);
  if (mode == kCausal) {
    hi0 = diag;
  } else if (mode == kSliding) {
    lo0 = max(0, r0 + j.q_offset - j.window + 1);
    hi0 = diag;
  } else if (mode == kSumi) {
    hi0 = min(j.n_history, diag);
    lo1 = max(j.n_history, j.q_offset + r0);
    hi1 = diag;
  }
  const int nt0 = hi0 > lo0 ? (hi0 - lo0 + kKeys - 1) / kKeys : 0;
  const int nt1 = hi1 > lo1 ? (hi1 - lo1 + kKeys - 1) / kKeys : 0;
  const int nt = nt0 + nt1;
  auto tile_at = [&](int i, int& t0, int& n) {
    const int lo = i < nt0 ? lo0 : lo1, hi = i < nt0 ? hi0 : hi1;
    t0 = lo + (i < nt0 ? i : i - nt0) * kKeys;
    n = min(kKeys, hi - t0);
  };

  const T* Q = static_cast<const T*>(j.q) + b * j.qs.n + h * j.qs.h +
               (long long)r0 * j.qs.s;
  const T* K = static_cast<const T*>(j.k) + b * j.ks.n + kvh * j.ks.h;
  const T* V = static_cast<const T*>(j.v) + b * j.vs.n + kvh * j.vs.h;
  const int nK = (j.D + DS - 1) / DS;  // score stages a tile
  const int nV = (cols + DS - 1) / DS; // P V stages a tile
  const int per = nK + nV;
  const int nst = nt * per;
  // stage st of the ring: tile st / per, its K (with Q) or V slice
  auto load = [&](int st) {
#ifdef ATTN_ANY_CUT_LOAD  // scripts/any_variants.py cut=k2noload
    return;
#endif
    const int i = st / per, sub = st - i * per;
    int t0, n;
    tile_at(i, t0, n);
    T* dst = ring + (st % slots) * slot;
    if (sub < nK) {
      stage_rows<T>(dst, LD, kKeys, K + (long long)t0 * j.ks.s, j.ks.s, n,
                    sub * DS, j.D);
      if (!geo.qres)
        stage_rows<T>(dst + kKeys * LD, LD, kRows, Q, j.qs.s, j.Sq - r0,
                      sub * DS, j.D);
    } else {
      stage_rows<T>(dst, LD, kKeys, V + (long long)t0 * j.vs.s, j.vs.s, n,
                    col0 + (sub - nK) * DS, j.D);
    }
  };

  float m[2] = {kNegInf, kNegInf};  // running max (unscaled) of g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float acc[NO][4];
#pragma unroll
  for (int jn = 0; jn < NO; ++jn)
    acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;

  if (geo.qres && nst > 0) {  // Q once, with the first stage's copies
#ifndef ATTN_ANY_CUT_LOAD
    for (int ks = 0; ks < nK; ++ks)
      stage_rows<T>(qbuf + ks * DS, geo.QLD, kRows, Q, j.qs.s, j.Sq - r0,
                    ks * DS, j.D);
#endif
  }
  for (int s = 0; s < slots - 1; ++s) {
    if (s < nst) load(s);
    mma::cp_async_commit();
  }
  int st = 0;
  auto next = [&]() {  // wait for stage st, refill the slot freed before it
    if (slots == kSlotsQ)
      mma::cp_async_wait<kSlotsQ - 2>();
    else
      mma::cp_async_wait<kSlots - 2>();
    __syncthreads();
    if (st + slots - 1 < nst) load(st + slots - 1);
    mma::cp_async_commit();
  };
  for (int i = 0; i < nt; ++i) {
    int t0, n;
    tile_at(i, t0, n);
    int state = warp_live ? tile_state(mode, A0, A1, t0, t0 + n - 1,
                                       j.window, j.n_history)
                          : 0;
    if (state == 1 && n < kKeys) state = 2;  // keys past n are padding
    // ---- S = Q K^T over the head dim, a slice a stage ----
    float s[NS][4];
#pragma unroll
    for (int jn = 0; jn < NS; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
    for (int ks = 0; ks < nK; ++ks, ++st) {
      next();
#ifndef ATTN_ANY_CUT_MMA  // scripts/any_variants.py cut=k2nomma
      if (state) {
        const T* kt = ring + (st % slots) * slot;
        const T* qt = geo.qres ? qbuf + warp * 16 * geo.QLD + ks * DS
                               : kt + (kKeys + warp * 16) * LD;
        const int qld = geo.qres ? geo.QLD : LD;
        const int dn = min(DS, j.D - ks * DS);
        if (dn == DS)
          scores<T, true>(s, qt, qld, kt, dn, lane);
        else
          scores<T, false>(s, qt, qld, kt, dn, lane);
      }
#endif
    }
    // ---- online softmax in f32; P in place of the scores ----
    if (state) {
      if (state == 2) {
#pragma unroll
        for (int jn = 0; jn < NS; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = jn * 8 + 2 * t + (e & 1);
            const int a = w0 + g + 8 * (e >> 1) + j.q_offset;
            if (col >= n ||
                !visible(mode, a, t0 + col, j.window, j.n_history))
              s[jn][e] = kNegInf;
          }
      }
      float ms[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m[half];
#pragma unroll
        for (int jn = 0; jn < NS; ++jn)
          mx = fmaxf(mx, fmaxf(s[jn][2 * half], s[jn][2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // 0 while the row has seen no visible key, so that its masked keys
        // still give exact zeros below
        ms[half] = mx == kNegInf ? 0.f : mx * scale2;
        const float corr = mma::ex2(m[half] * scale2 - ms[half]);
        l[half] *= corr;
#pragma unroll
        for (int jn = 0; jn < NO; ++jn) {
          acc[jn][2 * half] *= corr;
          acc[jn][2 * half + 1] *= corr;
        }
        m[half] = mx;
      }
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = mma::ex2(fmaf(s[jn][e], scale2, -ms[e >> 1]));
          l[e >> 1] += s[jn][e];
        }
    }
    // ---- O += P V over the pass's columns, a slice a stage ----
#pragma unroll
    for (int vs = 0; vs < MAXV; ++vs) {
      if (vs < nV) {
        next();
#ifndef ATTN_ANY_CUT_MMA
        if (state) {
          const T* vt = ring + (st % slots) * slot;
          if (n == kKeys && (vs + 1) * DS <= cols)
            pv<T, NO, true>(acc + vs * (DS / 8), s, vt, n, vs * DS, cols,
                            lane);
          else
            pv<T, NO, false>(acc + vs * (DS / 8), s, vt, n, vs * DS, cols,
                             lane);
        }
#endif
        ++st;
      }
    }
  }
  mma::cp_async_wait<0>();

  // ---- row sums across the quad; normalise; store ----
  T* O = static_cast<T*>(j.o) + b * j.os.n + h * j.os.h + col0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int r = w0 + g + 8 * half;
    if (r < j.Sq) {
      const float den = fmaxf(l[half], 1e-30f);
      T* orow = O + (long long)r * j.os.s;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        const int c = jn * 8 + 2 * t;
        if (c < cols) orow[c] = from_f32<T>(acc[jn][2 * half] / den);
        if (c + 1 < cols) orow[c + 1] = from_f32<T>(acc[jn][2 * half + 1] / den);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Job& j, cudaStream_t stream) {
  const int bytes = j.geo.bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  attention_any_kernel<T>
      <<<dim3((j.Sq + kRows - 1) / kRows, j.B * j.H, j.geo.passes), kThreads,
         bytes, stream>>>(j);
  return cudaGetLastError();
}

inline bool fits(int B, int H, const Geo& geo) {
  return (long long)B * H <= 65535 && geo.passes <= 65535;
}

inline Geo geometry_of(int dtype, int D) {
  return dtype == 0 ? geometry<float>(D) : geometry<__nv_bfloat16>(D);
}

}  // namespace any_attn
}  // namespace flame

using flame::Strides;
using flame::any_attn::Job;

static Strides strides3(const long long* s) {
  return Strides{s[0], s[1], s[2]};
}

// K2 at any head dim.  strides: 12 int64, (batch, seq, head) element strides
// of q, k, v, o (each row's D elements contiguous).
extern "C" int attention_any_k2_fwd(const void* q, const void* k,
                                    const void* v, void* o, int dtype, int B,
                                    int H, int Hkv, int Sq, int Sk, int D,
                                    const long long* strides, int mode,
                                    int window, int n_history, int q_offset,
                                    float scale, void* stream) {
  using namespace flame::any_attn;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 ||
      D <= 0 || mode < flame::kFull || mode > flame::kSumi)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Geo geo = geometry_of(dtype, D);
  if (!fits(B, H, geo)) return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.k = k; j.v = v; j.o = o;
  j.B = B; j.H = H; j.Hkv = Hkv; j.Sq = Sq; j.Sk = Sk; j.D = D;
  j.geo = geo;
  j.qs = strides3(strides); j.ks = strides3(strides + 3);
  j.vs = strides3(strides + 6); j.os = strides3(strides + 9);
  j.mode = mode; j.window = window; j.n_history = n_history;
  j.q_offset = q_offset; j.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(j, s);
  return launch<__nv_bfloat16>(j, s);
}

// Launch plan: out = grid x, y, z, threads, dynamic shared bytes, head-dim
// passes, columns a pass, keys a tile, Q kept in shared memory (1) or
// restaged with each K slice (0), ring slots.  Refuses what
// attention_any_k2_fwd refuses for its shapes.
extern "C" int attention_any_plan(int dtype, int B, int H, int Sq, int D,
                                  int* out) {
  using namespace flame::any_attn;
  if (B <= 0 || H <= 0 || Sq <= 0 || D <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Geo geo = geometry_of(dtype, D);
  if (!fits(B, H, geo)) return cudaErrorInvalidValue;
  out[0] = (Sq + kRows - 1) / kRows;
  out[1] = B * H;
  out[2] = geo.passes;
  out[3] = kThreads;
  out[4] = geo.bytes;
  out[5] = geo.passes;
  out[6] = geo.width;
  out[7] = kKeys;
  out[8] = geo.qres;
  out[9] = geo.slots;
  return cudaSuccess;
}
