// Any-head-size chunked RWKV-6 wkv scan for Hopper (sm_90a): the variant of
// kernel K5 (rwkv6_scan) that takes every head size its JAX wrapper takes.
//
// Replaces, past the tiled kernel's head sizes (32, 64; smaller ones run
// padded), the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel, which takes any head size.  The wrapper
// (kernels/rwkv6_scan/ops.py) sends here from the head size alone, before
// the launch; its launches count under rwkv6_scan.
//
// It computes the tiled kernel's function (rwkv6_scan.cu) with the tiled
// kernel's algorithm, its head size a run-time value: chunks of kC = 64
// steps, the decays factored through kSub = 4 sub-chunks of kL = 16 steps
// (with B_j = la at the last step of sub-chunk j and A_i = B_{i-1}, A_0 =
// 0: Q = r e^{la_prev - A_i}, K = k e^{B_j - la}; the scores' off-diagonal
// blocks (Q e^{A_i - B_j}) K^T, r e^{la_prev} = Q e^{A_i}, k e^{la_c - la}
// = K e^{la_c - B_j}), every exponent <= 0, so runs of w_log = -20 stay
// finite; only the diagonal 16 x 16 blocks keep the pairwise
// e^{la_prev[t] - la[s]}.
//
// Bound on an H100: the bytes at the shapes a model would run ([4, 500,
// 32, 128]: r / k / v bf16, w_log and the states f32, ~115 MB, 34 us); its
// TF32 products and exponentials take less.  The first port ran every
// product as a scalar f32 loop, took the pairwise exponential for every
// (t, s, d) below the diagonal in chunks of 32 steps, recomputed them in
// every 64-column block and kept its work area in device memory past head
// size 128: 2% of the bound.
//
// Design:
// - products on mma.sync.m16n8k8 TF32 with f32 accumulation, operands as
//   hi + lo (any_mma.cuh's split; bf16 v is exact in TF32 and takes two
//   products): the off-diagonal scores, r_dec S, sc v and k_dec^T v.  The
//   head size is a loop bound: rows pad to DP = D rounded up to 16 with
//   zeros (a zero r / k / v adds nothing; w_log 0 is no decay);
// - phases of a chunk, 256 threads, a barrier after each: P1 la and
//   la_prev (in place of w_log), summed in step order by one thread a
//   channel, and the per-channel scalars; P2 the diagonal blocks, pairwise, in 4 x 4 register tiles
//   (two warps on the 16 tiles on a block's diagonal, 4 lanes each; six on
//   the 24 below it, 8 lanes each; lanes take every 4th / 8th run of 4
//   channels and sum by shuffles); P3 Q and K in place of la_prev and la;
//   P4 the six off-diagonal blocks, one a warp; P5 o, a warp 32 value
//   columns of the row tiles of sub-chunks i and 3 - i (equal sc v work);
//   P6 the state's update, a warp 16 channels x 64 columns at a time;
// - r, k and v staged in their own dtype, and w_log as f32, by cp.async a
//   phase ahead of use (r / k of the next chunk once P3 has read them,
//   w_log into la_prev's rows once P5 has read Q, v once P6 has read it),
//   with 8- / 4-byte copies or element loads for rows off 16-byte
//   boundaries; the P5 / P6 items whose columns are all live run without
//   bound checks, so their loads hoist ahead of the products;
// - the state's value columns split over blocks: a block owns E columns,
//   E = ceil(D / splits) rounded up to 8, grid (ceil(D / E), B * H).
//   splits is the fewest (a power of two, E >= kMinCols) whose work area
//   fits in shared memory, then doubled while 2 x B x H x splits blocks
//   would still leave SMs of an H100 idle (kFillSMs): a function of the
//   shapes alone, decided here.  Each block recomputes the chunk's scores.
//   The split changes which block computes a column, never the order of
//   its sums, so a row alone and the same row inside a batch are bitwise
//   equal;
// - memory: a block's work area is r, k [64, DP] and v [64, E] in their
//   dtype, the scores' ten 16 x 16 blocks, 17 rows of per-channel scalars,
//   la_prev -> Q and la -> K [64, DP] f32 and the state's columns [DP, E]
//   f32.  Where it passes the 227 KB a block may have (at the fewest
//   columns), it lives in a device-memory workspace of one area a block,
//   staged by plain copies: rwkv6_scan_any_plan sizes it and
//   rwkv6_scan_any_fwd refuses a smaller one.
// Invariants: steps in a fixed order, no atomics: two calls agree bitwise.
// WKV_ANY_CLOCK: block (0, 0)'s thread 0 prints the cycles each phase took,
// summed over the chunks (each phase ends at its barrier).
#include <type_traits>
#ifdef WKV_ANY_CLOCK
#include <cstdio>
#endif

#include "attention_common.cuh"
#include "wkv_mma.cuh"

namespace flame {
namespace any_wkv {

using namespace wkv;

constexpr int kThreads = 256;
static_assert(kThreads % 256 == 0 && kThreads <= 512, "P2's lane split");
constexpr int kC = 64;         // steps a chunk
constexpr int kL = 16;         // steps a sub-chunk
constexpr int kSub = kC / kL;  // sub-chunks a chunk
constexpr int kBlocks = kSub * (kSub + 1) / 2;  // score blocks on or below
                                                // the diagonal
constexpr int kPB = kL + 4;    // score block row pitch
constexpr int kMinCols = 32;   // value columns a block, at least
constexpr int kFillSMs = 132;  // splits double while 2 B H splits <= this
constexpr int kSmemMax = 232448;  // shared memory a block may have (H100)
constexpr int kGroupO = 32;    // P5: value columns a warp item
constexpr int kGroupS = 64;    // P6: state columns a warp item
// per-channel scalars of a chunk, rows of DP floats
constexpr int kB = 0;          // B_j, kSub rows
constexpr int kEA = kB + kSub;  // e^{A_i}, kSub rows (row 0 = 1)
constexpr int kG = kEA + kSub;  // e^{la_c - B_j}, kSub rows (last = 1)
constexpr int kX = kG + kSub;   // e^{A_i - B_j} for i - 1 > j: (2,0),
                                // (3,0), (3,1)
constexpr int kDec = kX + 3;    // e^{la_c}
constexpr int kU = kDec + 1;    // u
constexpr int kScal = kU + 1;
static_assert(kSub == 4, "the cross-factor rows assume four sub-chunks");

__host__ __device__ inline int up(int x, int m) { return (x + m - 1) / m * m; }

// A block's work area: pitches (elements) and byte offsets.
struct Layout {
  int DP, E, EP, blocks, splits, smem;
  int PT, PV, PF, PS;
  long long r, k, v, sc, scal, lap, la, S, bytes;
};

inline Layout layout(int D, int E, int es) {
  Layout L{};
  L.DP = up(D, 16);
  L.E = E;
  L.EP = up(E, 8);
  L.blocks = (D + E - 1) / E;
  L.PT = L.DP + 16 / es;  // r, k rows
  L.PV = L.EP + 8;        // v rows
  L.PF = L.DP + 4;        // f32 rows: la_prev -> Q, la -> K
  L.PS = L.EP + 8;        // state rows
  L.r = 0;
  L.k = L.r + (long long)kC * L.PT * es;
  L.v = L.k + (long long)kC * L.PT * es;
  L.sc = L.v + up(kC * L.PV * es, 16);
  L.scal = L.sc + kBlocks * kL * kPB * 4;
  L.lap = L.scal + (long long)kScal * L.DP * 4;
  L.la = L.lap + (long long)kC * L.PF * 4;
  L.S = L.la + (long long)kC * L.PF * 4;
  L.bytes = L.S + (long long)L.DP * L.PS * 4;
  return L;
}

inline int cols(int D, int splits) { return up((D + splits - 1) / splits, 8); }

// The column split and where the work area lives: a function of the shapes
// alone, the one place that decides it.
inline Layout plan_layout(int B, int H, int D, int es) {
  int splits = 1;
  while (layout(D, cols(D, splits), es).bytes > kSmemMax &&
         cols(D, 2 * splits) >= kMinCols)
    splits *= 2;
  const bool smem = layout(D, cols(D, splits), es).bytes <= kSmemMax;
  if (!smem) splits = 1;  // the workspace: no need for more blocks
  while (2LL * B * H * splits <= kFillSMs && cols(D, 2 * splits) >= kMinCols)
    splits *= 2;
  Layout L = layout(D, cols(D, splits), es);
  L.splits = splits;
  L.smem = smem;
  return L;
}

// f32 floats of the workspace (0: the work area is in shared memory).
inline long long workspace_floats(const Layout& L, int B, int H) {
  return L.smem ? 0 : (long long)L.blocks * B * H * (L.bytes / 4);
}

struct Job {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* o;
  float* sf;
  unsigned char* ws;
  int H, S, D;
  Strides rs, ks, vs, wst, os;
  Layout L;
};

// Rows c0 .. c0 + kC - 1 of a [steps, cols] slice (row stride `stride`)
// into rows of `pitch` elements, `width` columns of which `live` are read
// (the rest zeros); rows at or past `len` are zero (the ragged tail: r = k =
// v = 0 adds nothing).  In shared memory by cp.async (16 bytes where the
// address allows, else 8 / 4 bytes with zero fill, else elements); in the
// workspace by plain copies.
template <typename T>
__device__ __forceinline__ void stage(bool async, T* dst, int pitch,
                                      const T* src, long long stride, int c0,
                                      int len, int width, int live) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int per = width / CH;
  if (async && live == width && c0 + kC <= len &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      ((stride * (long long)sizeof(T)) & 15) == 0) {
    // every row whole and on 16-byte boundaries: 16-byte copies only
    for (int i = threadIdx.x; i < kC * per; i += kThreads) {
      const int t = i / per, c = (i - t * per) * CH;
      mma::cp_async16(dst + t * pitch + c,
                      src + (long long)(c0 + t) * stride + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < kC * per; i += kThreads) {
    const int t = i / per, c = (i - t * per) * CH;
    T* d = dst + t * pitch + c;
    const int n = c0 + t < len ? min(CH, live - c) : 0;
    const T* s = n > 0 ? src + (long long)(c0 + t) * stride + c : src;
    if (!async) {
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = e < n ? s[e] : from_f32<T>(0.f);
      continue;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(s);
    if (n <= 0) {
      mma::cp_async16_zfill(d, src, false);
    } else if (n == CH && (a & 15) == 0) {
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
      for (int e = 0; e < 8; ++e) d[e] = e < n ? s[e] : from_f32<T>(0.f);
    }
  }
}

// One lane's share of a 4 x 4 tile of pairwise scores: rows t = tl .. tl +
// 3 against s = sl .. sl + 3 over the runs of 4 channels d0, d0 + step, ...
// below DP,
//   acc[a][z] = sum_d r[t,d] k[s,d] e^{la_prev[t,d] - la[s,d]}
// (a tile on the diagonal, DIAG: only z < a, and bon[a] = sum_d r u k of
// row a).  r / k rows are PT elements apart, la_prev / la rows PF floats.
template <typename T, bool DIAG>
__device__ __forceinline__ void diag_tile(float (&acc)[4][4], float* bon,
                                          const T* r_s, const T* k_s,
                                          const float* lap, const float* la,
                                          const float* u, int PT, int PF,
                                          int tl, int sl, int d0, int step,
                                          int DP) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    bon[a] = 0.f;
#pragma unroll
    for (int z = 0; z < 4; ++z) acc[a][z] = 0.f;
  }
  for (int d = d0; d < DP; d += step) {
    float rt[4][4], lp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      load4(r_s + (tl + a) * PT + d, rt[a]);
      load4(lap + (tl + a) * PF + d, lp[a]);
    }
    if (DIAG) {
      float uu[4];
      load4(u + d, uu);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float kk[4];
        load4(k_s + (sl + a) * PT + d, kk);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bon[a] = fmaf(rt[a][c] * uu[c], kk[c], bon[a]);
      }
    }
#pragma unroll
    for (int z = 0; z < (DIAG ? 3 : 4); ++z) {
      float kk[4], ls[4];
      load4(k_s + (sl + z) * PT + d, kk);
      load4(la + (sl + z) * PF + d, ls);
#pragma unroll
      for (int a = DIAG ? z + 1 : 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[a][z] = fmaf(rt[a][c] * kk[c], __expf(lp[a][c] - ls[c]),
                           acc[a][z]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) wkv_any_kernel(Job j) {
  const Layout& L = j.L;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* area =
      L.smem ? smem
             : j.ws + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                          L.bytes;
  const bool async = L.smem != 0;
  T* r_s = reinterpret_cast<T*>(area + L.r);
  T* k_s = reinterpret_cast<T*>(area + L.k);
  T* v_s = reinterpret_cast<T*>(area + L.v);
  float* sc_s = reinterpret_cast<float*>(area + L.sc);
  float* scal = reinterpret_cast<float*>(area + L.scal);
  float* lap_s = reinterpret_cast<float*>(area + L.lap);  // la_prev, then Q
  float* la_s = reinterpret_cast<float*>(area + L.la);    // la, then K
  float* S_s = reinterpret_cast<float*>(area + L.S);
  const int DP = L.DP, EP = L.EP, PT = L.PT, PV = L.PV, PF = L.PF,
            PS = L.PS, D = j.D;

  const int bh = blockIdx.y;
  const int b = bh / j.H, h = bh - b * j.H;
  const int e0 = blockIdx.x * L.E;
  const int ecols = min(L.E, D - e0);  // this block's value columns
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  const T* rb = static_cast<const T*>(j.r) + b * j.rs.n + h * j.rs.h;
  const T* kb = static_cast<const T*>(j.k) + b * j.ks.n + h * j.ks.h;
  const T* vb = static_cast<const T*>(j.v) + b * j.vs.n + h * j.vs.h + e0;
  const float* wb = j.w + b * j.wst.n + h * j.wst.h;
  T* ob = static_cast<T*>(j.o) + b * j.os.n + h * j.os.h + e0;
  const long long st0 = (long long)bh * D * D;  // state [b, h]

  for (int i = tid; i < DP * EP; i += kThreads) {
    const int d = i / EP, e = i - d * EP;
    S_s[d * PS + e] = j.s0 != nullptr && d < D && e < ecols
                          ? j.s0[st0 + (long long)d * D + e0 + e]
                          : 0.f;
  }
  for (int i = tid; i < DP; i += kThreads)
    scal[kU * DP + i] = i < D ? j.u[(long long)h * D + i] : 0.f;
  // the 4 x 4 tiles above each diagonal block's diagonal are zero for the
  // whole sequence (P2 writes only those on or below it)
  for (int x = tid; x < kSub * kL * kL; x += kThreads) {
    const int i = x / (kL * kL), tt = (x / kL) % kL, ss = x % kL;
    if (ss / 4 > tt / 4) sc_s[blk(i, i) * kL * kPB + tt * kPB + ss] = 0.f;
  }

  stage<float>(async, lap_s, PF, wb, j.wst.s, 0, j.S, DP, D);
  stage<T>(async, r_s, PT, rb, j.rs.s, 0, j.S, DP, D);
  stage<T>(async, k_s, PT, kb, j.ks.s, 0, j.S, DP, D);
  mma::cp_async_commit();
  stage<T>(async, v_s, PV, vb, j.vs.s, 0, j.S, EP, ecols);
  mma::cp_async_commit();

#ifdef WKV_ANY_CLOCK
  long long clk[8] = {}, mark = clock64();
  const bool timed = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0;
#define WKV_TICK(i)                    \
  if (timed) {                         \
    const long long now = clock64();   \
    clk[i] += now - mark;              \
    mark = now;                        \
  }
#else
#define WKV_TICK(i)
#endif
  const int n_chunks = (j.S + kC - 1) / kC;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC;
    const bool last = c == n_chunks - 1;
    // Copy groups, oldest first: w and r / k (c), v (c), then r / k
    // (c + 1), w (c + 1) and v (c + 1) committed during this chunk (empty
    // after the last).
    mma::cp_async_wait<1>();  // w, r / k of this chunk; v may fly on
    __syncthreads();
    WKV_TICK(0);

    // P1: la (inclusive, in step order) and la_prev = la - w in place of w,
    // one thread a channel; then the channel's scalars
    for (int d = tid; d < DP; d += kThreads) {
      float w[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) w[t] = lap_s[t * PF + d];  // loads first:
                                               // the stores below alias them
      float acc = 0.f, B[kSub];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        acc += w[t];
        la_s[t * PF + d] = acc;
        lap_s[t * PF + d] = acc - w[t];
        if (t % kL == kL - 1) B[t / kL] = acc;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        scal[(kB + jj) * DP + d] = B[jj];
        scal[(kEA + jj) * DP + d] = jj == 0 ? 1.f : __expf(B[jj - 1]);
        scal[(kG + jj) * DP + d] =
            jj == kSub - 1 ? 1.f : __expf(B[kSub - 1] - B[jj]);
      }
      scal[(kX + 0) * DP + d] = __expf(B[1] - B[0]);  // (i, j) = (2, 0)
      scal[(kX + 1) * DP + d] = __expf(B[2] - B[0]);  // (3, 0)
      scal[(kX + 2) * DP + d] = __expf(B[2] - B[1]);  // (3, 1)
      scal[kDec * DP + d] = __expf(B[kSub - 1]);
    }
    __syncthreads();
    WKV_TICK(1);

    // P2: the diagonal blocks of sc, pairwise, in 4 x 4 (t, s) register
    // tiles on or below each block's diagonal: the 16 on the diagonal (6
    // pairs and the bonus each; 4 lanes a tile) in warps 0-1, the 24 below
    // it (16 pairs; 8 lanes a tile) in warps 2-7
    constexpr int kLd = kThreads / 64, kLo = kThreads / 32;  // 4, 8
    if (tid < 16 * kLd) {
      const int part = tid % kLd, tile = tid / kLd;
      const int i = tile / 4, tl = i * kL + (tile % 4) * 4;
      float acc[4][4], bon[4];
      diag_tile<T, true>(acc, bon, r_s, k_s, lap_s, la_s, scal + kU * DP, PT,
                         PF, tl, tl, part * 4, kLd * 4, DP);
      reduce_tile<kLd>(acc, bon);
      if (part == 0) {
        float* blkp = sc_s + blk(i, i) * kL * kPB + (tile % 4) * 4 * (kPB + 1);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int z = 0; z < 4; ++z)
            blkp[a * kPB + z] = z < a ? acc[a][z] : (z == a ? bon[a] : 0.f);
      }
    } else if (tid < 16 * kLd + 24 * kLo) {
      const int item = tid - 16 * kLd;
      const int part = item % kLo, tile = item / kLo;
      const int i = tile / 6, p = tile % 6;  // (1,0) (2,0) (2,1) (3,0) ...
      const int tb = p < 1 ? 1 : (p < 3 ? 2 : 3);
      const int sb = p - (tb * (tb - 1)) / 2;
      float acc[4][4], bon[4];
      diag_tile<T, false>(acc, bon, r_s, k_s, lap_s, la_s, nullptr, PT, PF,
                          i * kL + tb * 4, i * kL + sb * 4, part * 4,
                          kLo * 4, DP);
      reduce_tile<kLo>(acc, bon);
      if (part == 0) {
        float* blkp = sc_s + blk(i, i) * kL * kPB + tb * 4 * kPB + sb * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int z = 0; z < 4; ++z) blkp[a * kPB + z] = acc[a][z];
      }
    }
    __syncthreads();
    WKV_TICK(2);

    // P3: the factors, in place: Q over la_prev, K over la; four channels
    // of one step a thread
    const int q4 = DP / 4;
    for (int x = tid; x < kC * q4; x += kThreads) {
      const int t = x / q4, d = (x - t * q4) * 4;
      const int i = t / kL;
      float rv[4], kv[4];
      load4(r_s + t * PT + d, rv);
      load4(k_s + t * PT + d, kv);
      float4* qp = reinterpret_cast<float4*>(lap_s + t * PF + d);
      float4* kp = reinterpret_cast<float4*>(la_s + t * PF + d);
      const float4 lp = *qp, l = *kp;
      const float4 Bj =
          *reinterpret_cast<const float4*>(scal + (kB + i) * DP + d);
      const float4 A = i == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : *reinterpret_cast<const float4*>(
                                    scal + (kB + i - 1) * DP + d);
      *qp = make_float4(
          rv[0] * __expf(lp.x - A.x), rv[1] * __expf(lp.y - A.y),
          rv[2] * __expf(lp.z - A.z), rv[3] * __expf(lp.w - A.w));
      *kp = make_float4(
          kv[0] * __expf(Bj.x - l.x), kv[1] * __expf(Bj.y - l.y),
          kv[2] * __expf(Bj.z - l.z), kv[3] * __expf(Bj.w - l.w));
    }
    __syncthreads();
    if (!last) {  // r and k are read: stage the next chunk's
      stage<T>(async, r_s, PT, rb, j.rs.s, t0 + kC, j.S, DP, D);
      stage<T>(async, k_s, PT, kb, j.ks.s, t0 + kC, j.S, DP, D);
    }
    mma::cp_async_commit();
    WKV_TICK(3);

    // P4: the off-diagonal blocks of sc = (Q e^{A_i - B_j}) K^T, one 16 x 16
    // block a warp (its A fragments shared by both 8-column halves)
    if (warp < 6) {
      // blocks in order (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
      const int i = warp < 1 ? 1 : (warp < 3 ? 2 : 3);
      const int jb = warp - (i * (i - 1)) / 2;
      const float* xs = i - 1 == jb ? nullptr
                        : scal + (kX + (i == 2 ? 0 : jb + 1)) * DP;
      float acc[2][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < DP; k0 += 8) {
        FragA a;
        a.load([&](int m, int kk) {
          const float qv = lap_s[(i * kL + m) * PF + k0 + kk];
          return xs ? qv * xs[k0 + kk] : qv;
        }, g, q);
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          FragB bb;
          bb.load([&](int kk, int n) {
            return la_s[(jb * kL + nh * 8 + n) * PF + k0 + kk];
          }, g, q);
          mma3(acc[nh], a, bb);
        }
      }
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float* blkp = sc_s + blk(i, jb) * kL * kPB + nh * 8 + 2 * q;
        blkp[g * kPB] = acc[nh][0];
        blkp[g * kPB + 1] = acc[nh][1];
        blkp[(g + 8) * kPB] = acc[nh][2];
        blkp[(g + 8) * kPB + 1] = acc[nh][3];
      }
    }
    mma::cp_async_wait<1>();  // this chunk's v (the next r / k may fly)
    __syncthreads();
    WKV_TICK(4);

    // P5: o = (Q e^{A_i}) S + sc v.  An item is the row tiles of
    // sub-chunks i and 3 - i (so every item multiplies the same number of
    // score blocks by v) and kGroupO value columns.
    {
      constexpr int NT = kGroupO / 8;
      const int items = 2 * ((EP + kGroupO - 1) / kGroupO);
      // FULL: all kGroupO columns live (no bound checks, so the compiler
      // can hoist the loads ahead of the products)
      auto item = [&](auto full, int it) {
        constexpr bool FULL = decltype(full)::value;
        const int mi[2] = {it % 2, kSub - 1 - it % 2};
        const int n0 = (it / 2) * kGroupO;
        float acc[2][NT][4];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int z = 0; z < 4; ++z) acc[mm][n][z] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < DP; k0 += 8) {
          FragB bb[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n)
            if (FULL || n0 + n * 8 < EP)
              bb[n].load([&](int kk, int nn) {
                return S_s[(k0 + kk) * PS + n0 + n * 8 + nn];
              }, g, q);
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            const float* eA = scal + (kEA + mi[mm]) * DP + k0;
            const float* qr = lap_s + mi[mm] * kL * PF + k0;
            FragA a;
            a.load([&](int m, int kk) { return qr[m * PF + kk] * eA[kk]; }, g,
                   q);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              if (FULL || n0 + n * 8 < EP) mma3(acc[mm][n], a, bb[n]);
          }
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int i = mi[mm];
          for (int jb = 0; jb <= i; ++jb) {
            const float* blkp = sc_s + blk(i, jb) * kL * kPB;
#pragma unroll
            for (int k1 = 0; k1 < kL; k1 += 8) {
              FragA a;
              a.load([&](int m, int kk) { return blkp[m * kPB + k1 + kk]; },
                     g, q);
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                if (FULL || n0 + n * 8 < EP) {
                  VFrag<T> vf;
                  vf.load(v_s, PV, jb * kL + k1, n0 + n * 8, g, q);
                  vf.mma(acc[mm][n], a);
                }
              }
            }
          }
          const int row = t0 + i * kL + g;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int z = 0; z < 4; ++z) {
              const int rr = row + 8 * (z >> 1);
              const int col = n0 + n * 8 + 2 * q + (z & 1);
              if (rr < j.S && col < ecols)
                ob[(long long)rr * j.os.s + col] = from_f32<T>(acc[mm][n][z]);
            }
          }
        }
      };
      for (int it = warp; it < items; it += kThreads / 32) {
        if ((it / 2 + 1) * kGroupO <= EP)
          item(std::true_type{}, it);
        else
          item(std::false_type{}, it);
      }
    }
    __syncthreads();  // every read of the old state and of Q is done
    if (!last) stage<float>(async, lap_s, PF, wb, j.wst.s, t0 + kC, j.S, DP, D);
    mma::cp_async_commit();
    WKV_TICK(5);

    // P6: S' = diag(e^{la_c}) S + k_dec^T v, an item 16 channels x kGroupS
    // columns
    {
      constexpr int NT = kGroupS / 8;
      const int ng = (EP + kGroupS - 1) / kGroupS;
      const int items = (DP / 16) * ng;
      const float* dec = scal + kDec * DP;
      auto item = [&](auto full, int it) {
        constexpr bool FULL = decltype(full)::value;
        const int m0 = (it / ng) * 16, n0 = (it % ng) * kGroupS;
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[n][z] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < kC; k0 += 8) {
          const float* gk = scal + (kG + k0 / kL) * DP + m0;
          FragA a;  // k_dec^T: a(d, s) = K[s][d] e^{la_c - B_j}
          a.load([&](int m, int kk) {
            return la_s[(k0 + kk) * PF + m0 + m] * gk[m];
          }, g, q);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (FULL || n0 + n * 8 < EP) {
              VFrag<T> vf;
              vf.load(v_s, PV, k0, n0 + n * 8, g, q);
              vf.mma(acc[n], a);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (FULL || n0 + n * 8 < EP) {
#pragma unroll
            for (int z = 0; z < 4; ++z) {
              const int d = m0 + g + (z >> 1) * 8;
              const int e = n0 + n * 8 + 2 * q + (z & 1);
              float* p = S_s + d * PS + e;
              const float s_new = __fadd_rn(__fmul_rn(dec[d], *p), acc[n][z]);
              *p = s_new;
              if (last && d < D && e < ecols)
                j.sf[st0 + (long long)d * D + e0 + e] = s_new;
            }
          }
        }
      };
      for (int it = warp; it < items; it += kThreads / 32) {
        if ((it % ng + 1) * kGroupS <= EP)
          item(std::true_type{}, it);
        else
          item(std::false_type{}, it);
      }
    }
    __syncthreads();  // every read of v is done
    if (!last) stage<T>(async, v_s, PV, vb, j.vs.s, t0 + kC, j.S, EP, ecols);
    mma::cp_async_commit();
    WKV_TICK(6);
  }
#ifdef WKV_ANY_CLOCK
  if (timed)
    printf("[clock] D %d E %d chunks %d: wait %lld P1 %lld P2 %lld P3 %lld "
           "P4+wait %lld P5 %lld P6 %lld\n", D, L.E, n_chunks, clk[0],
           clk[1], clk[2], clk[3], clk[4], clk[5], clk[6]);
#endif
}

template <typename T>
cudaError_t launch(const Job& j, int B, cudaStream_t stream) {
  const int bytes = j.L.smem ? (int)j.L.bytes : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  wkv_any_kernel<T><<<dim3(j.L.blocks, B * j.H), kThreads, bytes, stream>>>(
      j);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int S, int H, int D) {
  return B <= 0 || S <= 0 || H <= 0 || D <= 0 || (long long)B * H > 65535;
}

}  // namespace any_wkv
}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o); w_log, u, the states
// f32.  r, k, v, w_log, o [B, S, H, D] with strides: 15 int64, (batch, seq,
// head) of r, k, v, w_log, o, each row's D elements contiguous; u [H, D];
// state / state_out [B, H, D, D] contiguous (state null: zeros).  ws:
// ws_floats f32, at least rwkv6_scan_any_plan's out[6] (else refused; null
// where that is 0).
extern "C" int rwkv6_scan_any_fwd(const void* r, const void* k, const void* v,
                                  const void* w_log, const void* u,
                                  const void* state, void* o, void* state_out,
                                  void* ws, long long ws_floats, int dtype,
                                  int B, int S, int H, int D,
                                  const long long* strides, void* stream) {
  using namespace flame::any_wkv;
  using flame::Strides;
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Job j{};
  j.L = plan_layout(B, H, D, dtype == 0 ? 4 : 2);
  const long long need = workspace_floats(j.L, B, H);
  if (ws_floats < need || (need > 0 && ws == nullptr))
    return cudaErrorInvalidValue;
  j.r = r; j.k = k; j.v = v;
  j.w = static_cast<const float*>(w_log);
  j.u = static_cast<const float*>(u);
  j.s0 = static_cast<const float*>(state);
  j.o = o;
  j.sf = static_cast<float*>(state_out);
  j.ws = static_cast<unsigned char*>(ws);
  j.H = H; j.S = S; j.D = D;
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  j.rs = st[0]; j.ks = st[1]; j.vs = st[2]; j.wst = st[3]; j.os = st[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(j, B, s);
  return launch<__nv_bfloat16>(j, B, s);
}

// Launch plan: out = grid x (column blocks), grid y (B * H), threads,
// dynamic shared bytes, value columns a block, column splits, workspace
// floats (0: the work area in shared memory), work-area bytes a block.
// Refuses what rwkv6_scan_any_fwd refuses for its shapes.
extern "C" int rwkv6_scan_any_plan(int dtype, int B, int H, int D,
                                   long long* out) {
  using namespace flame::any_wkv;
  if (bad_shape(B, 1, H, D) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Layout L = plan_layout(B, H, D, dtype == 0 ? 4 : 2);
  out[0] = L.blocks;
  out[1] = (long long)B * H;
  out[2] = kThreads;
  out[3] = L.smem ? L.bytes : 0;
  out[4] = L.E;
  out[5] = L.splits;
  out[6] = workspace_floats(L, B, H);
  out[7] = L.bytes;
  return cudaSuccess;
}
