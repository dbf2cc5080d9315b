// Split-KV decode attention for Hopper (sm_90a): the any-dims variant of
// kernel K4 (flash_decode), its single-token form.
//
// Replaces, at the dims the tiled K4 kernels (flash_decode.cu) are not
// instantiated for, the Pallas TPU kernel repro/kernels/flash_decode/
// kernel.py::flash_decode_kernel (body _fd_kernel), whose wrapper pads D to
// the 128 lanes and so takes any head dim and group size.  The wrapper
// (kernels/flash_decode/ops.py: route) sends here, chosen from the dims
// before the launch, the single-token form past head dim 256 (f32: 128),
// past G = 16 query heads a KV head or past G * D = 1024.  Both kernels of
// a call count as launches of flash_decode.  (The self-slot form past head
// dim 128 is K1's cached mode over an unscaled history: it runs
// score_any.cu, this design extended to candidates and stored histories.)
//
// Bound on an H100: bytes.  Each valid cache element is read once for 4
// FLOPs a query row that reads it, so even 64 rows a key stay far below the
// ~300 FLOPs a byte where the tensor cores would bound it.  What a design
// must do is put enough blocks and enough bytes in flight: the TPU kernel's
// sequential walk over the cache, one (row, KV head) at a time, would leave
// most of 132 SMs idle at decode's few rows (8 blocks at [4, 16, 256] with
// 2 KV heads).
//
// Design (flash-decoding):
//   1. decode_any_split: a block owns the query heads of one KV head (up
//      to 64 of them; more take several blocks) and one split of kSplit =
//      64 cache positions.  Its grid is (splits, head groups x KV heads x
//      rows, head-dim passes); the split count is ceil(S / 64), a function
//      of the shapes alone.
//      Rows lie along the mma's n dimension, in tiles of 8 (8, 16, 32 or
//      64 rows a block), keys along m: scores^T = K q^T, out^T = V^T P^T,
//      so G = 4 fills half of one n tile instead of a quarter of an m tile.
//      The block stages the split's K (with its rows' q) and then its V
//      through a ring of shared-memory slots of kDS = 128 head-dim columns,
//      with 16-byte cp.async wherever a row's address allows (the ragged
//      tail of a head dim by element loads), and only the valid keys of the
//      split (the rest zero-filled, never read).  Every key tile is staged
//      once and scored against every row of the block.  Scores in f32,
//      softmax over the split's 64 keys (a masked key's weight an exact 0),
//      then the split's max, sum and f32 accumulator [rows, D] to a
//      workspace.
//   2. decode_any_combine: a block an output row merges the splits with
//      weights exp(m_i - max), skipping a split whose sum is 0 (its warps
//      take the splits in a fixed interleave, their partials summed in warp
//      order).  No atomics.
// Products on the tensor cores: bf16 operands on mma.sync m16n8k16 with f32
// accumulation, P as bf16 hi + lo (one bf16 rounding of P would cost ~2^-9
// of each weight); f32 operands on mma.sync m16n8k8 TF32 as split hi + lo
// (three products, any_mma.cuh), which keeps f32 accuracy.  The bound is
// bytes either way, so f32 could have stayed on the CUDA cores; the split
// lets both dtypes share one kernel body.
// Head dim: unbounded.  The accumulators live in registers, 64 a thread:
// 16 V slices of 128 columns at 8 rows, 2 at 64 rows; past that the grid's
// third dimension splits the output columns into passes, each of which
// recomputes the scores (the workspace holds the splits' partials).  The
// grid and the workspace are decided here alone: the wrapper sizes the
// workspace from decode_any_plan, and decode_any_fwd refuses a smaller one.
//
// Invariants: keys are read in a fixed order and the splits merged in a
// fixed order (independent of the data), so two calls agree bitwise; a
// split past `lengths` (or before the window) writes max -1e30 and sum 0
// and is skipped exactly, so a cache padded past `lengths` decodes bitwise
// like the tight one; the grid depends on the shapes only, and `lengths`
// is read on the device, never on the host (the wrapper runs inside
// captured executors).
#include <type_traits>

#include "any_mma.cuh"
#include "attention_common.cuh"

namespace flame {
namespace decode_any {

using bf16 = __nv_bfloat16;

constexpr int kSplit = 64;     // cache positions a split (one key tile)
constexpr int kThreads = 256;  // 8 warps
constexpr int kDS = 128;       // head-dim columns a ring slot
constexpr int kMaxRows = 64;   // rows a block
constexpr int kAccTiles = 16;  // V slices x row n tiles a thread holds
constexpr int kCombineThreads = 256;  // the merge: 8 warps a row
constexpr int kCombineCols = 512;     // ... columns a pass
constexpr int kCombineBatch = 4;      // ... splits a warp loads at once
                                      // where there are more than warps

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int KP = kDS + 8;     // K / q slice pitch (elements)
  static constexpr int VP = kDS + 8;     // V slice pitch
  static constexpr int PP = kSplit + 8;  // P pitch (hi and lo planes)
  static constexpr int NS = 3;           // ring slots
  static constexpr int CH = 8;           // elements a 16-byte copy
};
template <>
struct Cfg<float> {
  static constexpr int KP = kDS + 4;
  static constexpr int VP = kDS + 8;
  static constexpr int PP = kSplit + 4;
  static constexpr int NS = 2;
  static constexpr int CH = 4;
};

// Dynamic shared memory of a block of 8 * NT rows: the ring, the two
// column halves' partial scores [2][kSplit][rows] f32, and P [rows][PP]
// (f32, or bf16 hi and lo planes: 4 bytes an element either way).
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
// decides it (the wrapper sizes the workspace from decode_any_plan).
struct Geo {
  int G, GR, HT, NT, dc, passes, splits;
  long long rows_total;
};

inline Geo geometry(int B, int H, int Hkv, int S, int D) {
  Geo g{};
  g.G = H / Hkv;
  g.GR = g.G < kMaxRows ? g.G : kMaxRows;  // heads a block
  g.HT = (g.G + g.GR - 1) / g.GR;
  g.NT = g.GR <= 8 ? 1 : g.GR <= 16 ? 2 : g.GR <= 32 ? 4 : 8;
  g.dc = kAccTiles / g.NT * kDS;
  g.passes = (D + g.dc - 1) / g.dc;
  g.splits = S > 0 ? (S + kSplit - 1) / kSplit : 1;
  g.rows_total = (long long)B * H;
  return g;
}

// f32 floats of the workspace: each split's accumulators [rows_total][D],
// then each split's max and sum.
inline long long workspace_floats(const Geo& g, int D) {
  return (long long)g.splits * g.rows_total * (D + 2);
}

// Whether the grid fits the launch limits.
inline bool fits(const Geo& g, int B, int Hkv) {
  return (long long)B * Hkv * g.HT <= 65535 && g.passes <= 65535 &&
         g.rows_total <= 0x7fffffffLL;
}

struct Job {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [rows_total] log-sum-exp of each output row, or null
  float* ws;  // [splits][rows_total][D] accumulators, then [..][2] max, sum
  const int* lengths;  // valid prefix per cache row
  int B, H, Hkv, S, D, window;
  Geo geo;
  Strides qs, ks, vs, os;  // q / o: (batch, -, head)
};

// rows x kDS columns (from column d0) of rows at base + off(r) into shared
// memory of pitch ld; a row that is not live, or a column past D, is
// zero-filled.  16-byte cp.async where the address allows, else elements.
template <typename T, typename Off, typename Live>
__device__ __forceinline__ void stage(T* dst, int ld, int rows, const T* base,
                                      Off off, Live live, int d0, int D) {
  constexpr int CH = Cfg<T>::CH;
  constexpr int per_row = kDS / CH;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * CH;
    T* d = dst + r * ld + c;
    const int n = live(r) ? min(CH, D - d0 - c) : 0;
    if (n <= 0) {
      mma::cp_async16_zfill(d, base, false);
      continue;
    }
    const T* s = base + off(r) + d0 + c;
    if (n == CH && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      mma::cp_async16(d, s);
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        anymma::cp_async_zfill_n<4>(d + e, e < n ? s + e : base,
                                    e < n ? 4 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = e < n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) decode_any_split(Job j) {
  using C = Cfg<T>;
  using L = Smem<T, NT>;
  constexpr int R = 8 * NT;
  constexpr int MAXV = kAccTiles / NT;  // V slices a head-dim pass holds
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char sm[];
  float* sred = reinterpret_cast<float*>(sm + L::ring);
  unsigned char* pbuf = sm + L::ring + L::sred;
  __shared__ int live[kMaxRows];  // the row is a query head of the block
  __shared__ long long qoff[kMaxRows], grow[kMaxRows];
  __shared__ float mrow[kMaxRows], lrow[kMaxRows];

  const Geo& geo = j.geo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x;
  int y = blockIdx.y;
  const int ht = y % geo.HT;
  y /= geo.HT;
  const int kvh = y % j.Hkv;
  const int b = y / j.Hkv;
  const int g0 = ht * geo.GR;
  const int col0 = blockIdx.z * geo.dc;
  const int nK = (j.D + kDS - 1) / kDS;
  const int nV = (min(geo.dc, j.D - col0) + kDS - 1) / kDS;
  const T* Q = static_cast<const T*>(j.q);
  const T* K = static_cast<const T*>(j.k);
  const T* V = static_cast<const T*>(j.v);

  if (tid < R) {
    const bool on = tid < geo.GR && g0 + tid < geo.G;
    const int h = kvh * geo.G + g0 + tid;
    live[tid] = on;
    qoff[tid] = on ? b * j.qs.n + (long long)h * j.qs.h : 0;
    grow[tid] = (long long)b * j.H + h;
    mrow[tid] = kNegInf;
    lrow[tid] = 0.f;
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
  const int len = min(max(j.lengths[b], 0), j.S);
  const int lo = j.window > 0 ? max(0, len - j.window) : 0;
  const int klo = max(lo, split * kSplit);
  const int khi = min(len, split * kSplit + kSplit);
  __syncthreads();
  if (klo < khi) {  // else nothing of this row in this split
    const long long kb = b * j.ks.n + kvh * j.ks.h;
    const long long vb = b * j.vs.n + kvh * j.vs.h;
    auto key_live = [&](int r) {
      const int key = split * kSplit + r;
      return key >= klo && key < khi;
    };
    auto slot = [&](int s) { return reinterpret_cast<T*>(sm + s * L::slot); };
    const int nst = nK + nV;
    auto load = [&](int st) {
      T* dst = slot(st % C::NS);
      if (st < nK) {
        const int d0 = st * kDS;
        stage<T>(dst, C::KP, kSplit, K,
                 [&](int r) { return kb + (long long)(split * kSplit + r) *
                                              j.ks.s; },
                 key_live, d0, j.D);
        stage<T>(dst + kSplit * C::KP, C::KP, R, Q,
                 [&](int r) { return qoff[r]; },
                 [&](int r) { return live[r] != 0; }, d0, j.D);
      } else {
        stage<T>(dst, C::VP, kSplit, V,
                 [&](int r) { return vb + (long long)(split * kSplit + r) *
                                              j.vs.s; },
                 key_live, col0 + (st - nK) * kDS, j.D);
      }
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
      const T* ks = slot(st % C::NS) + km * 16 * C::KP;
      const T* qs = slot(st % C::NS) + kSplit * C::KP;
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
      const bool on = live[r] != 0;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = lane + 32 * e;
        ok[e] = on && key_live(key);
        s[e] = ok[e] ? sred[key * R + r] + sred[(kSplit + key) * R + r]
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
        const T* vs = slot(st % C::NS);
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
  __syncthreads();  // the rows' max and sum

  // ---- the split's partials to the workspace ----
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
          if (live[r] && dd < j.D) wacc[grow[r] * j.D + dd] = acc[v][n][e];
        }
      }
    }
  }
  if (blockIdx.z == 0 && tid < R && live[tid]) {
    float* ml = j.ws + (long long)geo.splits * rows_total * j.D +
                ((long long)split * rows_total + grow[tid]) * 2;
    ml[0] = mrow[tid];
    ml[1] = lrow[tid];
  }
}

// Fixed-order block reductions of the merge (a warp's xor tree, then the
// warps in order), so the merge's sums do not depend on the data.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) r += red[w];
  return r;
}

// A block an output row: the max over the splits, then the weights
// exp(m_i - max) of the splits with a sum > 0; warp w merges splits w, w +
// 8, ... in order, a lane 16 columns of each 512-column pass, loading U
// splits' weights and then their columns before it adds them (so the
// loads of a batch are in flight together: U = kCombineBatch for long
// caches, 1 where each warp has one split, whose registers would cost
// blocks in flight); the eight warps' partials are summed in warp order.
// The sums' order is the same at any U.  An empty split is skipped, so a
// padded cache's extra splits change no sum.
template <typename T, int U>
__global__ void __launch_bounds__(kCombineThreads) decode_any_combine(Job j) {
  constexpr int W = kCombineThreads / 32;
  constexpr int PER = kCombineCols / 32;  // columns a lane, a pass
  const Geo& geo = j.geo;
  const long long r = blockIdx.x;  // b * H + h
  const int h = (int)(r % j.H), b = (int)(r / j.H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* wacc = j.ws;
  const float* ml = j.ws + (long long)geo.splits * geo.rows_total * j.D;
  __shared__ float red[W];
  __shared__ float part[W][kCombineCols];

  auto at = [&](int i) { return ml + ((long long)i * geo.rows_total + r) * 2; };
  float mx = kNegInf;
  for (int i = tid; i < geo.splits; i += kCombineThreads)
    if (at(i)[1] > 0.f) mx = fmaxf(mx, at(i)[0]);
  mx = block_max(mx, red);
  float l = 0.f;
  for (int i = tid; i < geo.splits; i += kCombineThreads)
    if (at(i)[1] > 0.f) l += expf(at(i)[0] - mx) * at(i)[1];
  l = block_sum(l, red);
  const float den = fmaxf(l, 1e-30f);
  if (j.lse && tid == 0) j.lse[r] = mx + logf(l);  // -inf: no key
  T* o = static_cast<T*>(j.o) + b * j.os.n + (long long)h * j.os.h;
  for (int c0 = 0; c0 < j.D; c0 += kCombineCols) {
    float a[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) a[k] = 0.f;
    if constexpr (U == 1) {
      for (int i = warp; i < geo.splits; i += W) {
        const float* e = at(i);
        if (!(e[1] > 0.f)) continue;
        const float w = expf(e[0] - mx);
        const float* src =
            wacc + ((long long)i * geo.rows_total + r) * j.D + c0;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int c = lane + 32 * k;
          if (c0 + c < j.D) a[k] += w * src[c];
        }
      }
    } else {
      for (int i0 = warp; i0 < geo.splits; i0 += W * U) {
        float wu[U];  // the batch's weights, -1 for a skipped split
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * W;
          const float* e = i < geo.splits ? at(i) : nullptr;
          wu[u] = e && e[1] > 0.f ? expf(e[0] - mx) : -1.f;
        }
        float v[U][PER];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float* src =
              wacc + ((long long)(i0 + u * W) * geo.rows_total + r) * j.D +
              c0;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int c = lane + 32 * k;
            v[u][k] = wu[u] >= 0.f && c0 + c < j.D ? src[c] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (wu[u] >= 0.f) {
#pragma unroll
            for (int k = 0; k < PER; ++k) {
              const int c = lane + 32 * k;
              if (c0 + c < j.D) a[k] += wu[u] * v[u][k];
            }
          }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) part[warp][lane + 32 * k] = a[k];
    __syncthreads();
    for (int c = tid; c < kCombineCols && c0 + c < j.D;
         c += kCombineThreads) {
      float v = part[0][c];
#pragma unroll
      for (int w = 1; w < W; ++w) v += part[w][c];
      o[c0 + c] = from_f32<T>(v / den);
    }
    __syncthreads();
  }
}

// Launches the split kernel and the merge; *launched counts the kernels
// launched.
template <typename T, int NT>
cudaError_t launch(const Job& j, cudaStream_t stream, int* launched) {
  constexpr int bytes = Smem<T, NT>::total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_any_split<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  const Geo& g = j.geo;
  decode_any_split<T, NT>
      <<<dim3(g.splits, j.B * j.Hkv * g.HT, g.passes), kThreads,
         bytes, stream>>>(j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  if (g.splits > kCombineThreads / 32)
    decode_any_combine<T, kCombineBatch>
        <<<(unsigned)g.rows_total, kCombineThreads, 0, stream>>>(j);
  else
    decode_any_combine<T, 1>
        <<<(unsigned)g.rows_total, kCombineThreads, 0, stream>>>(j);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
cudaError_t dispatch(const Job& j, cudaStream_t s, int* launched) {
  switch (j.geo.NT) {
    case 1: return launch<T, 1>(j, s, launched);
    case 2: return launch<T, 2>(j, s, launched);
    case 4: return launch<T, 4>(j, s, launched);
    default: return launch<T, 8>(j, s, launched);
  }
}

template <typename T>
int smem_of(int NT) {
  switch (NT) {
    case 1: return Smem<T, 1>::total;
    case 2: return Smem<T, 2>::total;
    case 4: return Smem<T, 4>::total;
    default: return Smem<T, 8>::total;
  }
}

}  // namespace decode_any
}  // namespace flame

using flame::Strides;
using flame::decode_any::Job;

static Strides strides3(const long long* s) {
  return Strides{s[0], s[1], s[2]};
}

static bool bad_shape(int B, int H, int Hkv, int S, int D) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S < 0 || D <= 0;
}

// K4's single-token form at any head dim and group size: q [B, H, D], each
// row seeing its cache row's valid prefix (the last `window` positions of
// it where window > 0).  strides: 12 int64, (outer, seq, head) of q, k, v,
// o (q / o as [B, 1, H, D]).  lengths [B] int32.  lse: null, or [B, H] f32
// for each output row's log-sum-exp.  ws: ws_floats f32, at least
// decode_any_plan's out64[0] (else refused).  q carries the softmax scale.
// *launched: the kernels this call launched.
extern "C" int decode_any_fwd(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, float* lse,
                              void* ws, long long ws_floats, int dtype, int B,
                              int H, int Hkv, int S, int D,
                              const long long* strides, int window,
                              void* stream, int* launched) {
  using namespace flame::decode_any;
  if (!launched) return cudaErrorInvalidValue;
  *launched = 0;
  if (bad_shape(B, H, Hkv, S, D) || window < 0 || !lengths || !ws)
    return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.k = k; j.v = v; j.o = o;
  j.lse = lse;
  j.ws = static_cast<float*>(ws);
  j.lengths = static_cast<const int*>(lengths);
  j.B = B; j.H = H; j.Hkv = Hkv; j.S = S; j.D = D;
  j.window = window;
  j.geo = geometry(B, H, Hkv, S, D);
  if (!fits(j.geo, B, Hkv) || ws_floats < workspace_floats(j.geo, D))
    return cudaErrorInvalidValue;
  j.qs = strides3(strides); j.ks = strides3(strides + 3);
  j.vs = strides3(strides + 6); j.os = strides3(strides + 9);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(j, s, launched);
  if (dtype == 1) return dispatch<__nv_bfloat16>(j, s, launched);
  return cudaErrorInvalidValue;
}

// Launch plan: out = split grid (x, y, z), threads, dynamic shared bytes,
// rows a block, key splits, head-dim passes, combine blocks, combine
// threads, kernels a call; out64[0] = workspace floats.  Refuses what
// decode_any_fwd refuses for its shapes.
extern "C" int decode_any_plan(int dtype, int B, int H, int Hkv, int S,
                               int D, int* out, long long* out64) {
  using namespace flame::decode_any;
  if (bad_shape(B, H, Hkv, S, D) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Geo g = geometry(B, H, Hkv, S, D);
  if (!fits(g, B, Hkv)) return cudaErrorInvalidValue;
  out[0] = g.splits;
  out[1] = B * Hkv * g.HT;
  out[2] = g.passes;
  out[3] = kThreads;
  out[4] = dtype == 0 ? smem_of<float>(g.NT) : smem_of<__nv_bfloat16>(g.NT);
  out[5] = 8 * g.NT;
  out[6] = g.splits;
  out[7] = g.passes;
  out[8] = (int)g.rows_total;
  out[9] = kCombineThreads;
  out[10] = 2;  // decode_any_split, decode_any_combine
  out64[0] = workspace_floats(g, D);
  return cudaSuccess;
}
