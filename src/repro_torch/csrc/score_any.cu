// Split-KV candidate scoring for Hopper (sm_90a): the any-dims variant of
// kernel K1 (fused_score).
//
// Replaces, at the head dims the tiled K1 kernels (fused_score.cu:
// cached_score.cuh, extend_score.cuh) are not instantiated for, the Pallas
// TPU kernel repro/kernels/fused_score/kernel.py::fused_score_kernel (body
// _fused_kernel), whose wrapper pads D to the 128 lanes and so takes any
// head dim.  The wrapper (kernels/fused_score/ops.py: route) sends here,
// chosen from the dims before the launch, every call past head dim 128, in
// both modes, for every q dtype and history dtype.  It computes the same
// function: a two-segment softmax per (batch row, head, query) over
//   segment 1: the pooled history of the row's pool row (row_index [B], the
//              DSO's KV-row dedup, or [B, M] in cached mode: a pool row per
//              candidate, DSO v2 segment packing) in the pool's stored
//              precision -- int8, bf16 or f32 -- with the per-(pool row, kv
//              head) scales, bounded by lengths[row] (read on the device);
//   segment 2: "cached" -- the candidate's own key (SUMI); "extend" -- the
//              suffix keys at or before the query, which sits at absolute
//              position P + i (causal).
// Both kernels of a call count as launches of fused_score.  K4's self-slot
// form (kernels/flash_decode/ops.py: route_self) is this cached mode over an
// unscaled history in q's dtype, and past head dim 128 runs here too,
// counted under flash_decode_with_self.
//
// Bound on an H100: bytes.  At the wide-head Climber's cached shape (q [4,
// 128, 4, 256] bf16 over an int8 history of 257 positions for 4 pool rows)
// the function moves ~6.3 MB and does ~0.27 GFLOP: ~1.9 us of memory time,
// far under the ~300 FLOPs a byte where the tensor cores would bound it.
//
// Design (flash-decoding, decode_any.cu's split decode extended to the rows
// of several candidates and to the pool's stored history):
//   1. score_any_split: a block owns up to 64 rows that read the same keys
//      -- the heads of up to 64 candidates of one batch row and kv head --
//      and one split of kSplit = 64 keys: a split of the history (there are
//      ceil(S / 64), one empty split at S = 0) or, in extend mode, of the
//      suffix (ceil(M / 64) more, after the history's).  Its grid is (row
//      groups x kv heads, splits, head-dim passes), a function of the
//      shapes alone; the row groups lie on x, so B * H has no 65535 limit.
//      Rows lie along the mma's n dimension (8, 16, 32 or 64 a block), keys
//      along m: scores^T = K q^T, out^T = V^T P^T.  The split's K (with the rows' q) and then its V are
//      staged through a ring of shared-memory slots of kDS = 128 head-dim
//      columns in the compute type: bf16 for bf16 q over an int8 or bf16
//      history (int8 codes are exact in bf16), f32 otherwise (bf16 q over an
//      f32 history, f32 q over any history: split TF32, any_mma.cuh).  A
//      slot whose source has the compute type fills by cp.async; the others
//      (int8 / bf16 codes into bf16 / f32) by vector loads converted in
//      registers.  Only the split's live keys are staged (the rest
//      zero-filled, never weighted).  Scores in f32, multiplied by scale *
//      k_scale[row, kv head] (history) or scale (suffix); a softmax over the
//      split's keys (a masked key's weight an exact 0); the split's max, sum
//      and its accumulator times v_scale[row, kv head] (history) to a
//      workspace.  A packed index: the block takes one pass per distinct
//      pool row among its rows, in the order the rows first appear, each
//      pass weighting only that row's candidates.
//   2. score_any_combine: a block an output row merges the splits in index
//      order, each thread the same sequence: the max over the splits with a
//      sum > 0 (and, cached, the candidate's own key), the weights exp(m_i -
//      max), the denominator, each column's weighted sum, then (cached) the
//      own key last.  No atomics.
// Products on the tensor cores: bf16 on mma.sync m16n8k16 with f32
// accumulation, P as bf16 hi + lo; f32 on mma.sync m16n8k8 TF32 as split hi
// + lo (three products).  The accumulators live in registers, 64 a thread;
// past dc columns the grid's third dimension splits the output columns into
// passes, each of which recomputes the scores.  The grid and the workspace
// are decided here alone: the wrapper sizes the workspace from
// score_any_plan, and score_any_fwd refuses a smaller one.
//
// Invariants (the engine's bitwise checks rely on them): keys are read in a
// fixed order and the splits merged in a fixed order independent of the
// data, so two calls agree bitwise; a split with no key of a row writes max
// -1e30 and sum 0 and is skipped exactly, and the merge visits the splits in
// order whatever their number, so a history padded past `lengths` scores
// bitwise like the tight one; a row's output depends on its q row, its pool
// row, its length and its own key (cached) or the suffix rows up to it
// (extend) alone, so the rows of an M = 5 call equal those of an M = 128
// (129) call and a packed candidate equals its unpacked call; the grid
// depends on the shapes only, and row_index / lengths are read on the
// device, never on the host (the wrapper runs inside captured executors).
#include <type_traits>

#include "any_mma.cuh"
#include "attention_common.cuh"

namespace flame {
namespace score_any {

using bf16 = __nv_bfloat16;

constexpr int kCached = 0, kExtend = 1;
constexpr int kSplit = 64;     // keys a split (one key tile)
constexpr int kThreads = 256;  // 8 warps
constexpr int kDS = 128;       // head-dim columns a ring slot
constexpr int kMaxRows = 64;   // rows a block
constexpr int kAccTiles = 16;  // V slices x row n tiles a thread holds
constexpr int kCombineThreads = 256;

// Staging layout per compute type (pitches in elements, padded against
// bank conflicts).
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int KP = kDS + 8;     // K / q slice pitch
  static constexpr int VP = kDS + 8;     // V slice pitch
  static constexpr int PP = kSplit + 8;  // P pitch (hi and lo planes)
  static constexpr int NS = 3;           // ring slots
  static constexpr int CH = 8;           // elements a 16-byte chunk
};
template <>
struct Cfg<float> {
  static constexpr int KP = kDS + 4;
  static constexpr int VP = kDS + 8;
  static constexpr int PP = kSplit + 4;
  static constexpr int NS = 2;
  static constexpr int CH = 4;
};

// Dynamic shared memory of a block of 8 * NT rows: the ring, the two column
// halves' partial scores [2][kSplit][rows] f32, and P [rows][PP] (f32, or
// bf16 hi and lo planes: 4 bytes an element either way).
template <typename T, int NT>
struct Smem {
  static constexpr int R = 8 * NT;
  static constexpr int kq = (kSplit + R) * Cfg<T>::KP;
  static constexpr int v = kSplit * Cfg<T>::VP;
  static constexpr int slot =
      ((kq > v ? kq : v) * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int ring = Cfg<T>::NS * slot;
  static constexpr int sred = 2 * kSplit * R * 4;
  static constexpr int p = R * Cfg<T>::PP * 4;
  static constexpr int total = ring + sred + p;
};

// The launch geometry, a function of the shapes alone: the one place that
// decides it (the wrapper sizes the workspace from score_any_plan).
struct Geo {
  int G, GR, HT, CG, CGN, NT, dc, passes, hsplits, splits;
  long long groups, rows_total;
};

inline Geo geometry(int B, int M, int H, int Hkv, int S, int D, int mode) {
  Geo g{};
  g.G = H / Hkv;
  g.GR = g.G < kMaxRows ? g.G : kMaxRows;  // heads a block
  g.HT = (g.G + g.GR - 1) / g.GR;
  g.CG = kMaxRows / g.GR;                  // candidates a block
  if (g.CG > M) g.CG = M;
  if (g.CG < 1) g.CG = 1;
  g.CGN = (M + g.CG - 1) / g.CG;
  const int rows = g.CG * g.GR;
  g.NT = rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8;
  g.dc = kAccTiles / g.NT * kDS;
  g.passes = (D + g.dc - 1) / g.dc;
  g.hsplits = S > 0 ? (S + kSplit - 1) / kSplit : 1;
  g.splits = g.hsplits + (mode == kExtend ? (M + kSplit - 1) / kSplit : 0);
  g.groups = (long long)B * g.CGN * Hkv * g.HT;
  g.rows_total = (long long)B * M * H;
  return g;
}

// f32 floats of the workspace: each split's accumulators [rows_total][D],
// then each split's max and sum.
inline long long workspace_floats(const Geo& g, int D) {
  return (long long)g.splits * g.rows_total * (D + 2);
}

// Whether the grids fit the launch limits.
inline bool fits(const Geo& g) {
  return g.groups <= 0x7fffffffLL && g.splits <= 65535 &&
         g.passes <= 65535 && g.rows_total <= 0x7fffffffLL;
}

struct Job {
  const void* q;
  const void* kh;  // history [U, S, Hkv, D], stored type
  const void* vh;
  const float* ks;  // [U, Hkv] multipliers or null (1)
  const float* vs;
  const void* kc;  // candidates / suffix [B, M, Hkv, D], q's type
  const void* vc;
  const int* row_index;  // [B] or [B, M] (packed) or null (b)
  const int* lengths;    // [U] or null (S)
  void* o;
  float* ws;  // [splits][rows_total][D] accumulators, then [..][2] max, sum
  int B, M, H, Hkv, U, S, D, mode, packed;
  Geo geo;
  Strides qs, khs, vhs, kcs, vcs, os;
  float scale;
};

template <int BYTES>
struct Raw;
template <>
struct Raw<4> {
  using T = unsigned;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<16> {
  using T = uint4;
};

template <typename TC>
__device__ __forceinline__ TC cvt(float x) {
  return from_f32<TC>(x);
}

// rows x kDS columns (from column d0) of rows at base + off(r), type TS,
// into shared memory of pitch ld as TC; a row that is not live, or a column
// past D, is zero-filled.  TS == TC: 16-byte cp.async where the address
// allows, else elements.  TS != TC (int8 or bf16 codes widened, exactly):
// CH-element vector loads where the address allows, else elements,
// converted in registers and stored as 16 bytes.
template <typename TC, typename TS, typename Off, typename Live>
__device__ __forceinline__ void stage(TC* dst, int ld, int rows,
                                      const TS* base, Off off, Live live,
                                      int d0, int D) {
  constexpr int CH = Cfg<TC>::CH;
  constexpr int per_row = kDS / CH;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * CH;
    TC* d = dst + r * ld + c;
    const int n = live(r) ? min(CH, D - d0 - c) : 0;
    if constexpr (std::is_same<TC, TS>::value) {
      if (n <= 0) {
        mma::cp_async16_zfill(d, base, false);
        continue;
      }
      const TS* s = base + off(r) + d0 + c;
      if (n == CH && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        mma::cp_async16(d, s);
      } else if constexpr (std::is_same<TC, float>::value) {
#pragma unroll
        for (int e = 0; e < CH; ++e)
          anymma::cp_async_zfill_n<4>(d + e, e < n ? s + e : base,
                                      e < n ? 4 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e)
          d[e] = e < n ? s[e] : __float2bfloat16(0.f);
      }
    } else {
      constexpr int BYTES = CH * (int)sizeof(TS);
      using V = typename Raw<BYTES>::T;
      alignas(16) TS in[CH];
      alignas(16) TC out[CH];
      if (n > 0) {
        const TS* s = base + off(r) + d0 + c;
        if (n == CH && (reinterpret_cast<uintptr_t>(s) % BYTES) == 0) {
          *reinterpret_cast<V*>(in) = *reinterpret_cast<const V*>(s);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e)
            if (e < n) in[e] = s[e];
        }
#pragma unroll
        for (int e = 0; e < CH; ++e)
          out[e] = cvt<TC>(e < n ? to_f32(in[e]) : 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) out[e] = cvt<TC>(0.f);
      }
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(out);
    }
  }
}

template <typename TQ, typename TH, typename TC, int NT>
__global__ void __launch_bounds__(kThreads) score_any_split(Job j) {
  using C = Cfg<TC>;
  using L = Smem<TC, NT>;
  constexpr int R = 8 * NT;
  constexpr int MAXV = kAccTiles / NT;  // V slices a head-dim pass holds
  constexpr bool kF32 = std::is_same<TC, float>::value;
  extern __shared__ __align__(128) unsigned char sm[];
  float* sred = reinterpret_cast<float*>(sm + L::ring);
  unsigned char* pbuf = sm + L::ring + L::sred;
  __shared__ int prow[kMaxRows];  // pool row of each row (0: suffix), -1 dead
  __shared__ int mpos[kMaxRows];  // candidate / suffix index of each row
  __shared__ int done[kMaxRows];
  __shared__ int act[kMaxRows];   // the row belongs to this pass
  __shared__ long long qoff[kMaxRows], grow[kMaxRows];
  __shared__ float mrow[kMaxRows], lrow[kMaxRows], vrow[kMaxRows];
  __shared__ int pass_row;

  const Geo& geo = j.geo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const bool hist = split < geo.hsplits;
  long long y = blockIdx.x;
  const int ht = (int)(y % geo.HT);
  y /= geo.HT;
  const int kvh = (int)(y % j.Hkv);
  y /= j.Hkv;
  const int c0 = (int)(y % geo.CGN) * geo.CG;
  const int b = (int)(y / geo.CGN);
  const int g0 = ht * geo.GR;
  const int col0 = blockIdx.z * geo.dc;
  const int nK = (j.D + kDS - 1) / kDS;
  const int nV = (min(geo.dc, j.D - col0) + kDS - 1) / kDS;
  const TQ* Q = static_cast<const TQ*>(j.q);

  if (tid < R) {
    const int c = tid / geo.GR, gg = tid - (tid / geo.GR) * geo.GR;
    const bool live =
        tid < geo.CG * geo.GR && c0 + c < j.M && g0 + gg < geo.G;
    const int m = c0 + c, h = kvh * geo.G + g0 + gg;
    int row = -1;
    if (live)
      row = !hist ? 0
            : j.packed ? j.row_index[(long long)b * j.M + m]
            : j.row_index ? j.row_index[b] : b;
    prow[tid] = row;
    mpos[tid] = m;
    done[tid] = 0;
    qoff[tid] = live ? b * j.qs.n + (long long)m * j.qs.s +
                           (long long)h * j.qs.h
                     : 0;
    grow[tid] = ((long long)b * j.M + m) * j.H + h;
    mrow[tid] = kNegInf;
    lrow[tid] = 0.f;
    vrow[tid] = 1.f;
  }
  float acc[MAXV][NT][4];
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[v][n][e] = 0.f;

  const int km = warp & 3;   // scores: key m tile
  const int kh = warp >> 2;  // scores: half of each slot's columns
  for (;;) {
    __syncthreads();
    if (tid == 0) {
      int r0 = -1;
      for (int r = 0; r < R; ++r)
        if (prow[r] >= 0 && !done[r]) {
          r0 = prow[r];
          break;
        }
      pass_row = r0;
    }
    __syncthreads();
    const int row = pass_row;
    if (row < 0) break;
    // this pass's keys [klo, khi) of the split, their source and scales
    int klo, khi;
    float c_score, c_v = 1.f;
    if (hist) {
      const int len = j.lengths ? min(max(j.lengths[row], 0), j.S) : j.S;
      klo = split * kSplit;
      khi = min(len, klo + kSplit);
      c_score = j.scale * (j.ks ? j.ks[row * j.Hkv + kvh] : 1.f);
      if (j.vs) c_v = j.vs[row * j.Hkv + kvh];
    } else {
      klo = (split - geo.hsplits) * kSplit;
      khi = min(j.M, klo + kSplit);
      if (klo > c0 + geo.CG - 1) khi = klo;  // no row of the block sees it
      c_score = j.scale;
    }
    if (tid < R) {
      act[tid] = prow[tid] == row;
      if (act[tid]) {
        done[tid] = 1;
        vrow[tid] = c_v;
      }
    }
    __syncthreads();
    if (klo >= khi) continue;  // nothing of this row in this split

    auto slot = [&](int s) {
      return reinterpret_cast<TC*>(sm + s * L::slot);
    };
    const int nst = nK + nV;
    auto load = [&](int st) {
      TC* dst = slot(st % C::NS);
      const bool is_k = st < nK;
      const int d0 = is_k ? st * kDS : col0 + (st - nK) * kDS;
      const int pitch = is_k ? C::KP : C::VP;
      if (hist) {
        const Strides& ss = is_k ? j.khs : j.vhs;
        const long long kb = row * ss.n + kvh * ss.h;
        stage<TC>(dst, pitch, kSplit,
                  static_cast<const TH*>(is_k ? j.kh : j.vh),
                  [&](int r) { return kb + (long long)(klo + r) * ss.s; },
                  [&](int r) { return klo + r < khi; }, d0, j.D);
      } else {
        const Strides& ss = is_k ? j.kcs : j.vcs;
        const long long kb = b * ss.n + kvh * ss.h;
        stage<TC>(dst, pitch, kSplit,
                  static_cast<const TQ*>(is_k ? j.kc : j.vc),
                  [&](int r) { return kb + (long long)(klo + r) * ss.s; },
                  [&](int r) { return klo + r < khi; }, d0, j.D);
      }
      if (is_k)
        stage<TC>(dst + kSplit * C::KP, C::KP, R, Q,
                  [&](int r) { return qoff[r]; },
                  [&](int r) { return act[r] != 0; }, d0, j.D);
    };
#pragma unroll
    for (int s = 0; s < C::NS - 1; ++s) {
      if (s < nst) load(s);
      mma::cp_async_commit();
    }
    // ---- scores^T [kSplit, R] = K q^T over the whole head dim ----
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
    for (int st = 0; st < nK; ++st) {
      mma::cp_async_wait<C::NS - 2>();
      __syncthreads();
      if (st + C::NS - 1 < nst) load(st + C::NS - 1);
      mma::cp_async_commit();
      const TC* ks = slot(st % C::NS) + km * 16 * C::KP;
      const TC* qs = slot(st % C::NS) + kSplit * C::KP;
      if constexpr (kF32) {
#pragma unroll 2
        for (int kk = kh * (kDS / 2); kk < (kh + 1) * (kDS / 2); kk += 8) {
          const float a[4] = {ks[g * C::KP + kk + t],
                              ks[(g + 8) * C::KP + kk + t],
                              ks[g * C::KP + kk + t + 4],
                              ks[(g + 8) * C::KP + kk + t + 4]};
          unsigned ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* qr = qs + (8 * n + g) * C::KP + kk;
            const float bq[2] = {qr[t], qr[t + 4]};
            anymma::mma_split_b(sacc[n], ah, al, bq);
          }
        }
      } else {
#pragma unroll
        for (int kk = kh * (kDS / 2); kk < (kh + 1) * (kDS / 2); kk += 16) {
          unsigned a[4];
          a[0] = mma::ld32(ks + g * C::KP + kk + 2 * t);
          a[1] = mma::ld32(ks + (g + 8) * C::KP + kk + 2 * t);
          a[2] = mma::ld32(ks + g * C::KP + kk + 8 + 2 * t);
          a[3] = mma::ld32(ks + (g + 8) * C::KP + kk + 8 + 2 * t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const bf16* qr = qs + (8 * n + g) * C::KP + kk;
            const unsigned bq[2] = {mma::ld32(qr + 2 * t),
                                    mma::ld32(qr + 8 + 2 * t)};
            mma::mma_bf16(sacc[n], a, bq);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int key = km * 16 + g, r = 8 * n + 2 * t;
      float* s0 = sred + (kh * kSplit + key) * R + r;
      s0[0] = sacc[n][0];
      s0[1] = sacc[n][1];
      s0[8 * R] = sacc[n][2];
      s0[8 * R + 1] = sacc[n][3];
    }
    __syncthreads();
    // ---- softmax over the split's keys: a warp a row, a lane two keys ----
    for (int r = warp; r < R; r += kThreads / 32) {
      const bool on = act[r] != 0;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = lane + 32 * e;
        ok[e] = on && klo + key < khi && (hist || klo + key <= mpos[r]);
        s[e] = ok[e] ? (sred[key * R + r] + sred[(kSplit + key) * R + r]) *
                           c_score
                     : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float p[2], sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = ok[e] ? expf(s[e] - mx) : 0.f;
        sum += p[e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = lane + 32 * e;
        if constexpr (kF32) {
          reinterpret_cast<float*>(pbuf)[r * C::PP + key] = p[e];
        } else {
          bf16* ph = reinterpret_cast<bf16*>(pbuf);
          const bf16 hi = __float2bfloat16(p[e]);
          ph[r * C::PP + key] = hi;
          ph[R * C::PP + r * C::PP + key] =
              __float2bfloat16(p[e] - __bfloat162float(hi));
        }
      }
      if (lane == 0 && on) {
        mrow[r] = mx;
        lrow[r] = sum;
      }
    }
    // ---- out^T [D, R] += V^T P^T, a warp 16 columns of each slice ----
    const int dm = warp * 16;
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      if (v < nV) {
        const int st = nK + v;
        mma::cp_async_wait<C::NS - 2>();
        __syncthreads();
        if (st + C::NS - 1 < nst) load(st + C::NS - 1);
        mma::cp_async_commit();
        const TC* vs = slot(st % C::NS);
        if constexpr (kF32) {
          const float* pp = reinterpret_cast<const float*>(pbuf);
#pragma unroll 2
          for (int kk = 0; kk < kSplit; kk += 8) {
            const float a[4] = {vs[(kk + t) * C::VP + dm + g],
                                vs[(kk + t) * C::VP + dm + g + 8],
                                vs[(kk + t + 4) * C::VP + dm + g],
                                vs[(kk + t + 4) * C::VP + dm + g + 8]};
            unsigned ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const float* pr = pp + (8 * n + g) * C::PP + kk;
              const float bp[2] = {pr[t], pr[t + 4]};
              anymma::mma_split_b(acc[v][n], ah, al, bp);
            }
          }
        } else {
          const bf16* ph = reinterpret_cast<const bf16*>(pbuf);
          const bf16* pl = ph + R * C::PP;
#pragma unroll
          for (int kk = 0; kk < kSplit; kk += 16) {
            unsigned a[4];
            anymma::load_a_trans_x4(a, vs, C::VP, kk, dm, lane);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int o = (8 * n + g) * C::PP + kk + 2 * t;
              const unsigned bl[2] = {mma::ld32(pl + o), mma::ld32(pl + o + 8)};
              const unsigned bh[2] = {mma::ld32(ph + o), mma::ld32(ph + o + 8)};
              mma::mma_bf16(acc[v][n], a, bl);
              mma::mma_bf16(acc[v][n], a, bh);
            }
          }
        }
      }
    }
    mma::cp_async_wait<0>();
  }

  // ---- the split's partials to the workspace, v scale applied ----
  const long long rows_total = geo.rows_total;
  float* wacc = j.ws + (long long)split * rows_total * j.D;
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    if (v < nV) {
      const int d = col0 + v * kDS + warp * 16 + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * n + 2 * t + (e & 1);
          const int dd = d + 8 * (e >> 1);
          if (prow[r] >= 0 && dd < j.D)
            wacc[grow[r] * j.D + dd] = acc[v][n][e] * vrow[r];
        }
      }
    }
  }
  if (blockIdx.z == 0 && tid < R && prow[tid] >= 0) {
    float* ml = j.ws + (long long)geo.splits * rows_total * j.D +
                ((long long)split * rows_total + grow[tid]) * 2;
    ml[0] = mrow[tid];
    ml[1] = lrow[tid];
  }
}

// A block an output row: every thread walks the splits in index order (the
// same sequence, so the same max and sum), skipping a split whose sum is 0;
// a thread a column of each kCombineThreads-column pass sums its weighted
// accumulators in that order, then (cached) adds the candidate's own key.
// The own key's score: a fixed-order block reduction of q . k_self.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads) score_any_combine(Job j) {
  constexpr int W = kCombineThreads / 32;
  const Geo& geo = j.geo;
  const long long r = blockIdx.x;  // (b * M + m) * H + h
  const int h = (int)(r % j.H);
  const long long bm = r / j.H;
  const int m = (int)(bm % j.M), b = (int)(bm / j.M);
  const int tid = threadIdx.x;
  const float* ml = j.ws + (long long)geo.splits * geo.rows_total * j.D;
  const bool self = j.mode == kCached;
  __shared__ float red[W];

  float s_self = kNegInf;
  const TQ* vself = nullptr;
  if (self) {
    const int kvh = h / geo.G;
    const TQ* q = static_cast<const TQ*>(j.q) + b * j.qs.n +
                  (long long)m * j.qs.s + (long long)h * j.qs.h;
    const TQ* ks = static_cast<const TQ*>(j.kc) + b * j.kcs.n +
                   (long long)m * j.kcs.s + (long long)kvh * j.kcs.h;
    vself = static_cast<const TQ*>(j.vc) + b * j.vcs.n +
            (long long)m * j.vcs.s + (long long)kvh * j.vcs.h;
    float dot = 0.f;
    for (int c = tid; c < j.D; c += kCombineThreads)
      dot = fmaf(to_f32(q[c]), to_f32(ks[c]), dot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((tid & 31) == 0) red[tid >> 5] = dot;
    __syncthreads();
    float sum = red[0];
#pragma unroll
    for (int w = 1; w < W; ++w) sum += red[w];
    s_self = sum * j.scale;
  }
  auto at = [&](int i) { return ml + ((long long)i * geo.rows_total + r) * 2; };
  float mx = s_self;
  for (int i = 0; i < geo.splits; ++i)
    if (at(i)[1] > 0.f) mx = fmaxf(mx, at(i)[0]);
  float l = 0.f;
  for (int i = 0; i < geo.splits; ++i)
    if (at(i)[1] > 0.f) l += expf(at(i)[0] - mx) * at(i)[1];
  const float es = self ? expf(s_self - mx) : 0.f;
  const float den = fmaxf(l + es, 1e-30f);
  TQ* o = static_cast<TQ*>(j.o) + b * j.os.n + (long long)m * j.os.s +
          (long long)h * j.os.h;
  for (int c = tid; c < j.D; c += kCombineThreads) {
    float a = 0.f;
    for (int i = 0; i < geo.splits; ++i) {
      const float* e = at(i);
      if (e[1] > 0.f)
        a += expf(e[0] - mx) *
             j.ws[((long long)i * geo.rows_total + r) * j.D + c];
    }
    if (self) a += es * to_f32(vself[c]);
    o[c] = from_f32<TQ>(a / den);
  }
}

// Launches the split kernel and the merge; *launched counts the kernels
// launched.
template <typename TQ, typename TH, typename TC, int NT>
cudaError_t launch(const Job& j, cudaStream_t stream, int* launched) {
  constexpr int bytes = Smem<TC, NT>::total;
  auto kernel = score_any_split<TQ, TH, TC, NT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const Geo& g = j.geo;
  kernel<<<dim3((unsigned)g.groups, g.splits, g.passes), kThreads, bytes,
           stream>>>(j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  score_any_combine<TQ>
      <<<(unsigned)g.rows_total, kCombineThreads, 0, stream>>>(j);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename TQ, typename TH, typename TC>
cudaError_t dispatch_nt(const Job& j, cudaStream_t s, int* launched) {
  switch (j.geo.NT) {
    case 1: return launch<TQ, TH, TC, 1>(j, s, launched);
    case 2: return launch<TQ, TH, TC, 2>(j, s, launched);
    case 4: return launch<TQ, TH, TC, 4>(j, s, launched);
    default: return launch<TQ, TH, TC, 8>(j, s, launched);
  }
}

// The compute type: bf16 for bf16 q over an int8 or bf16 history, f32
// otherwise.
template <typename TQ, typename TH>
using Compute = typename std::conditional<
    std::is_same<TQ, bf16>::value && !std::is_same<TH, float>::value, bf16,
    float>::type;

template <typename TQ>
cudaError_t dispatch_hist(int hist_dtype, const Job& j, cudaStream_t s,
                          int* launched) {
  switch (hist_dtype) {
    case 0:
      return dispatch_nt<TQ, float, Compute<TQ, float>>(j, s, launched);
    case 1:
      return dispatch_nt<TQ, bf16, Compute<TQ, bf16>>(j, s, launched);
    case 2:
      return dispatch_nt<TQ, int8_t, Compute<TQ, int8_t>>(j, s, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TC>
int smem_of(int NT) {
  switch (NT) {
    case 1: return Smem<TC, 1>::total;
    case 2: return Smem<TC, 2>::total;
    case 4: return Smem<TC, 4>::total;
    default: return Smem<TC, 8>::total;
  }
}

}  // namespace score_any
}  // namespace flame

using flame::Strides;
using flame::score_any::Job;

static bool bad_shape(int B, int M, int H, int Hkv, int U, int S, int D,
                      int mode, int q_dtype, int hist_dtype) {
  return B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || U <= 0 ||
         S < 0 || D <= 0 || (mode != 0 && mode != 1) ||
         (q_dtype != 0 && q_dtype != 1) || hist_dtype < 0 || hist_dtype > 2;
}

// K1 at any head dim (operand conventions of fused_score_fwd).
// q_dtype (q, k_cand, v_cand, o): 0 = float32, 1 = bfloat16.
// hist_dtype (k_hist, v_hist): 0 = float32, 1 = bfloat16, 2 = int8.
// k_scale / v_scale: [U, Hkv] f32 multipliers or NULL (= 1).
// row_index: [B] int32 pool row per batch row, [B, M] (packed != 0: a pool
// row per candidate, cached mode only) or NULL (= b).
// lengths: [U] int32 valid history prefix per pool row or NULL (= S).
// strides: 18 int64 -- (outer, seq, head) element strides of q, k_hist,
// v_hist, k_cand, v_cand, o.  ws: ws_floats f32, at least score_any_plan's
// out64[0] (else refused).  scale multiplies the f32 scores.
// *launched: the kernels this call launched.
extern "C" int score_any_fwd(const void* q, const void* k_hist,
                             const void* v_hist, const float* k_scale,
                             const float* v_scale, const void* k_cand,
                             const void* v_cand, const int* row_index,
                             const int* lengths, void* o, void* ws,
                             long long ws_floats, int q_dtype, int hist_dtype,
                             int packed, int B, int M, int H, int Hkv, int U,
                             int S, int D, const long long* strides, int mode,
                             float scale, void* stream, int* launched) {
  using namespace flame::score_any;
  if (!launched) return cudaErrorInvalidValue;
  *launched = 0;
  if (bad_shape(B, M, H, Hkv, U, S, D, mode, q_dtype, hist_dtype) || !ws ||
      (packed && (mode != kCached || !row_index)))
    return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.kh = k_hist; j.vh = v_hist; j.ks = k_scale; j.vs = v_scale;
  j.kc = k_cand; j.vc = v_cand; j.row_index = row_index; j.lengths = lengths;
  j.o = o;
  j.ws = static_cast<float*>(ws);
  j.B = B; j.M = M; j.H = H; j.Hkv = Hkv; j.U = U; j.S = S; j.D = D;
  j.mode = mode; j.packed = packed;
  j.geo = geometry(B, M, H, Hkv, S, D, mode);
  if (!fits(j.geo) || ws_floats < workspace_floats(j.geo, D))
    return cudaErrorInvalidValue;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  j.qs = st[0]; j.khs = st[1]; j.vhs = st[2]; j.kcs = st[3]; j.vcs = st[4];
  j.os = st[5];
  j.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_hist<float>(hist_dtype, j, s, launched);
  return dispatch_hist<__nv_bfloat16>(hist_dtype, j, s, launched);
}

// Launch plan: out = split grid (x: row groups x kv heads, y: key splits,
// the history's then the suffix's, z: head-dim passes), threads, dynamic
// shared bytes, rows a block, history splits, combine blocks, combine
// threads, kernels a call, 1 if the products are bf16 (else split TF32);
// out64[0] = workspace floats.
// Refuses what score_any_fwd refuses for its shapes.
extern "C" int score_any_plan(int q_dtype, int hist_dtype, int mode, int B,
                              int M, int H, int Hkv, int S, int D, int* out,
                              long long* out64) {
  using namespace flame::score_any;
  if (bad_shape(B, M, H, Hkv, 1, S, D, mode, q_dtype, hist_dtype))
    return cudaErrorInvalidValue;
  const Geo g = geometry(B, M, H, Hkv, S, D, mode);
  if (!fits(g)) return cudaErrorInvalidValue;
  const bool bf = q_dtype == 1 && hist_dtype != 0;
  out[0] = (int)g.groups;
  out[1] = g.splits;
  out[2] = g.passes;
  out[3] = kThreads;
  out[4] = bf ? smem_of<__nv_bfloat16>(g.NT) : smem_of<float>(g.NT);
  out[5] = 8 * g.NT;
  out[6] = g.hsplits;
  out[7] = (int)g.rows_total;
  out[8] = kCombineThreads;
  out[9] = 2;  // score_any_split, score_any_combine
  out[10] = bf;
  out64[0] = workspace_floats(g, D);
  return cudaSuccess;
}
