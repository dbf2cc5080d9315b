// Candidate scoring for Hopper (sm_90a) at any head dim: the any-dims
// variant of kernel K1 (fused_score), one launch a call.
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
// K4's self-slot form (kernels/flash_decode/ops.py: route_self) is this
// cached mode over an unscaled history in q's dtype, and past head dim 128
// runs here too, counted under flash_decode_with_self.
//
// Bound on an H100: bytes.  At the wide-head Climber's cached shape (q [4,
// 128, 4, 256] bf16 over an int8 history of 257 positions for 4 pool rows)
// the function moves ~6.3 MB and does ~0.27 GFLOP: ~1.9 us of memory time,
// far under the ~300 FLOPs a byte where the tensor cores would bound it.
// What a design has to avoid at that size is extra traffic and latency:
// a workspace round trip, a second kernel, a second wave, stalls on copies.
// Its device times on an H100 at the wide-head Climber's shapes, beside
// SDPA's and the bound (chip_smoke.py, CUDA-graph replays), are in PERF.md
// section 6: at 5-6% of the bound it is held by latency and issue a split.
//
// Design: a thread-block cluster of kCluster = 4 CTAs for each row group.
//   - A row group: up to 64 rows that read the same keys -- the heads of up
//     to 64 candidates of one batch row and kv head (8, 16, 32 or 64 rows
//     a CTA, the products' n dimension; keys along m: scores^T = K q^T,
//     out^T = V^T P^T).  The grid is (row groups x kCluster, head-dim
//     passes), a function of the shapes alone; the row groups lie on x,
//     so B * H has no 65535 limit.
//   - The keys in splits of kSplit = 64: the history's splits i (of the
//     pass's pool row, i * 64 < lengths[row]) and, in extend mode, the
//     suffix's splits j (the keys before a row's own; the own key comes
//     last, in the merge), each numbered from 0 in its own segment.  CTA
//     r of the cluster takes the splits with i = r (mod kCluster) in index
//     order, then (extend) the suffix splits with j = r (mod kCluster), and
//     folds each into its rows' running state (max m, sum l, f32
//     accumulator in registers): m' = max(m, split max), alpha = exp(m -
//     m'), l = l alpha + sum p, acc = acc alpha + P V.  A split where a row
//     sees no key leaves the row's state untouched (no rescale); after its
//     history splits a CTA multiplies its accumulators by v_scale[row, kv
//     head].  The dealing depends on the split indices alone, so padding
//     the history past lengths moves no live split to another CTA.
//   - The kCluster states are then merged on chip in rank order: each CTA
//     leaves its accumulators in its shared memory, the cluster syncs, and
//     each CTA reads every rank's (m, l, acc) for its share of the output
//     columns through distributed shared memory (map_shared_rank): M = the
//     max over the ranks with l > 0 and the own key's score (which rank r
//     computes for the rows r mod kCluster), weights exp(m_r - M), the
//     denominator and each column's sum in rank order, then the own key
//     last (cached: the candidate's; extend: the suffix key at the row's
//     position, so that an M = 1 call folds no suffix split); it writes its
//     columns of the output.  No workspace, no second kernel, no atomics.
//   - Staging in the stored type: every K / V slice (64 keys x kDS = 128
//     head-dim columns) of the history (int8 / bf16 / f32) or the suffix
//     (q's type) is copied as stored by 16-byte cp.async (zero-filled past
//     the split's live keys and past D) into a ring of 3-4 slots; the copy
//     of slice k + 2 or k + 3 is in flight while slice k is multiplied,
//     across split and pass boundaries.  Codes are widened to the compute
//     type between shared memory and the fragments (int8 to bf16 exactly,
//     by byte permutes and an f32 add).  A chunk whose source is not
//     16-byte aligned or ends past D (a ragged D, an odd pitch) falls back
//     to element loads.
//   - q of every live row is staged once a CTA (all of D, by cp.async; for
//     bf16 products in the 128-byte swizzled layout wgmma reads); a packed
//     index makes a pass per distinct pool row among the CTA's rows, in
//     the order the rows first appear, each pass weighting only that
//     row's candidates, the passes' splits one stream of copies.
//   - The softmax of a split: four threads a row, each 16 consecutive keys,
//     reduced in one fixed order at every row count; exponentials as 2^x
//     on the special-function unit.  P enters the second product as bf16
//     hi and lo tiles (swizzled), over the scores' bytes.
//   - Shared memory: q, the scores / P buffer, the ring; after the splits
//     the same bytes hold the accumulators the cluster reads.  The ring
//     takes 4 slots where two CTAs of 256 threads then fit an SM (int8
//     history at D 256: 86 KB), else 3 (bf16 history, or extend over int8:
//     101 KB): two CTAs an SM, so the wide-head shapes' grids (16-48
//     clusters) run in one wave.
// Products on the tensor cores: bf16 (bf16 q over an int8 or bf16
// history) on wgmma at every row count (A the widened keys / V^T in
// registers, B q^T / P^T by descriptor, f32 accumulation; one instruction
// family, so that a row's sums never depend on how many rows share its
// CTA); f32 (f32 q, or a f32 history) on mma.sync m16n8k8 TF32 as split
// hi + lo (three products).  The accumulators live in registers, 64 a
// thread; past dc columns the grid's y dimension splits the output
// columns into passes, each of which recomputes the scores.  The launch
// is decided here alone: score_any_plan reports it (grid, cluster, CTAs,
// shared bytes, blocks resident an SM, resident clusters).
//
// Invariants (the engine's bitwise checks rely on them): keys are read and
// splits folded and merged in an order fixed by the split indices, so two
// calls agree bitwise; a split past lengths is never visited and the merge
// skips a rank with l = 0 exactly, so a history padded past lengths scores
// bitwise like the tight one, and lengths == S like none; a row's output
// depends on its q row, its pool row, its length and its own key (cached)
// or the suffix rows up to it (extend) alone, so the rows of an M = 5 call
// equal those of an M = 128 (129) call and a packed candidate equals its
// unpacked call; the grid depends on the shapes only, and row_index /
// lengths are read on the device, never on the host (the wrapper runs
// inside captured executors); the launch allocates nothing.
#include <cooperative_groups.h>

#include <cstdio>
#include <type_traits>

#include "any_mma.cuh"
#include "attention_common.cuh"

namespace flame {
namespace score_any {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kCached = 0, kExtend = 1;
constexpr int kSplit = 64;     // keys a split
constexpr int kCluster = 4;    // CTAs a row group; CTA r folds splits = r
constexpr int kThreads = 256;  // 8 warps
constexpr int kDS = 128;       // head-dim columns a staged slice
constexpr int kMaxRows = 64;   // rows a CTA
constexpr int kAccTiles = 16;  // V slices x row n tiles a thread holds
constexpr int kSPP = kSplit * 4 + 16;     // bytes a row of scores / P
constexpr int kTwoPerSM = 106 * 1024;     // dynamic bytes of 2 CTAs an SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 220 * 1024;      // dynamic bytes of 1 CTA an SM

// The launch geometry, a function of the shapes alone: the one place that
// decides it.
struct Geo {
  int G, GR, HT, CG, CGN, NT, dc, passes, hsplits, nK;
  int qp;                 // q pitch, elements
  int pitch_h, pitch_q;   // bytes a key row of a history / suffix slice
  int slot_bytes, slots;  // the ring
  int q_bytes, sp_bytes, state_pitch, smem;
  long long groups;
};

// Built with -DSCORE_ANY_CLOCK (scripts/any_variants.py cut=k1clock), the
// first and last CTAs' thread 0 print the cycles each phase took.
#ifdef SCORE_ANY_CLOCK
#define SCORE_ANY_TICK(name)                                          \
  do {                                                                \
    if (clk_on) {                                                     \
      const long long now = clock64();                                \
      printf("score_any clk cta %u rank %d %s %lld\n", blockIdx.x,     \
             rank, name, now - clk_t);                                \
      clk_t = clock64();                                              \
    }                                                                 \
  } while (0)
#else
#define SCORE_ANY_TICK(name) \
  do {                       \
  } while (0)
#endif

inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Dynamic shared bytes of a CTA of 8 * nt rows, and (out) its parts: q
// (the bf16 compute type: 128-byte swizzled blocks of 64 columns, as wgmma
// reads it; f32: rows padded), the scores / P buffer, the ring, each
// region 1024-byte aligned (1024 bytes more to align the base).
inline int smem_of(Geo& g, int nt, int D, int q_size, int h_size,
                   int mode, int slots) {
  const int R = 8 * nt;
  const bool swz = q_size == 2 && h_size != 4;
  g.nK = (D + kDS - 1) / kDS;
  g.qp = g.nK * kDS + 16 / q_size;
  g.q_bytes = round_up(swz ? R * g.nK * kDS * 2 : R * g.qp * q_size, 1024);
  g.sp_bytes = round_up(R * kSPP, 1024);
  g.pitch_h = kDS * h_size + 16;
  g.pitch_q = kDS * q_size + 16;
  const int pitch = mode == kExtend && g.pitch_q > g.pitch_h ? g.pitch_q
                                                             : g.pitch_h;
  g.slot_bytes = round_up(kSplit * pitch, 128);
  const int dc = kAccTiles / nt * kDS;
  g.state_pitch = round_up(dc < D ? dc : D, 4) + 4;
  const int stage = g.q_bytes + g.sp_bytes + slots * g.slot_bytes;
  const int state = R * g.state_pitch * 4;
  return (stage > state ? stage : state) + 1024;
}

inline Geo geometry(int B, int M, int H, int Hkv, int S, int D, int mode,
                    int q_size, int h_size) {
  Geo g{};
  g.G = H / Hkv;
  // the most rows a CTA whose shared memory fits one SM
  int nt_max = 0;
  for (int nt = 8; nt >= 1 && !nt_max; nt /= 2)
    if (smem_of(g, nt, D, q_size, h_size, mode, 3) <= kMaxSmem) nt_max = nt;
  const int rmax = 8 * (nt_max ? nt_max : 1);
  g.GR = g.G < rmax ? g.G : rmax;  // heads a CTA
  g.HT = (g.G + g.GR - 1) / g.GR;
  g.CG = rmax / g.GR;              // candidates a CTA
  if (g.CG > M) g.CG = M;
  if (g.CG < 1) g.CG = 1;
  g.CGN = (M + g.CG - 1) / g.CG;
  const int rows = g.CG * g.GR;
  g.NT = rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8;
  g.dc = kAccTiles / g.NT * kDS;
  g.passes = (D + g.dc - 1) / g.dc;
  g.hsplits = (S + kSplit - 1) / kSplit;
  // 4 ring slots where two CTAs an SM still fit, else 3
  g.slots = 4;
  g.smem = smem_of(g, g.NT, D, q_size, h_size, mode, 4);
  if (g.smem > kTwoPerSM) {
    g.slots = 3;
    g.smem = smem_of(g, g.NT, D, q_size, h_size, mode, 3);
  }
  if (!nt_max) g.smem = kMaxSmem + 1;  // refused by fits()
  g.groups = (long long)B * g.CGN * Hkv * g.HT;
  return g;
}

// Whether the launch fits the card's limits.
inline bool fits(const Geo& g) {
  return g.groups * kCluster <= 0x7fffffffLL && g.passes <= 65535 &&
         g.smem <= kMaxSmem;
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
  int B, M, H, Hkv, U, S, D, mode, packed;
  Geo geo;
  Strides qs, khs, vhs, kcs, vcs, os;
  float scale;
};

template <typename T>
__device__ __forceinline__ T zero_of() {
  return static_cast<T>(0);
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}

// rows x ncols columns (from column d0) of rows at base + off(r), stored
// type TS, into shared memory at at(r, c) (a 16-byte chunk each), as
// stored: 16-byte cp.async, zero-filled for a row that is not live or
// columns past D; a chunk whose source is not 16-byte aligned or that ends
// past D by element loads.
template <typename TS, typename At, typename Off, typename Live>
__device__ __forceinline__ void stage(At at, int rows, const TS* base,
                                      Off off, Live live, int d0, int D,
                                      int ncols) {
  constexpr int CH = 16 / (int)sizeof(TS);
  const int per_row = ncols / CH;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * CH;
    unsigned char* d = at(r, c);
    const int n = live(r) ? min(CH, D - d0 - c) : 0;
    if (n <= 0) {
      mma::cp_async16_zfill(d, base, false);
      continue;
    }
    const TS* s = base + off(r) + d0 + c;
    if (n == CH && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      mma::cp_async16(d, s);
    } else {
      TS* e = reinterpret_cast<TS*>(d);
#pragma unroll
      for (int k = 0; k < CH; ++k) e[k] = k < n ? s[k] : zero_of<TS>();
    }
  }
}

// Four consecutive elements of T as one access (8 bytes of bf16, 16 of
// f32); p aligned to it.
template <typename T>
using Quad = typename std::conditional<sizeof(T) == 2, uint2, uint4>::type;
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  alignas(16) T x[4];
  *reinterpret_cast<Quad<T>*>(x) = *reinterpret_cast<const Quad<T>*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = to_f32(x[e]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  alignas(16) T x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = from_f32<T>(v[e]);
  *reinterpret_cast<Quad<T>*>(p) = *reinterpret_cast<const Quad<T>*>(x);
}

// cp.async.wait_group n for the ring's runtime depth (n = slots - 2).
__device__ __forceinline__ void wait_pending(int n) {
  if (n >= 2)
    mma::cp_async_wait<2>();
  else if (n == 1)
    mma::cp_async_wait<1>();
  else
    mma::cp_async_wait<0>();
}

// bf16 pair (p[0] low, p[1] high) of a row of stored codes.
__device__ __forceinline__ unsigned pair_bf16(const bf16* p) {
  return mma::ld32(p);
}
// Two int8 codes (bytes 0 and 1 of w) as a bf16 pair, exactly, on the
// integer and f32 add units: each code c biased to c + 128 becomes the low
// mantissa byte of 2^23 (the f32 2^23 + c + 128), less 2^23 + 128 gives c,
// whose 8 or fewer significant bits make its bf16 the f32's high half.
__device__ __forceinline__ unsigned widen2(unsigned w) {
  const unsigned u = w ^ 0x8080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) -
                   8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}
__device__ __forceinline__ unsigned pair_bf16(const int8_t* p) {
  return widen2(*reinterpret_cast<const unsigned short*>(p));
}

// scores^T of one K slice for the f32 compute type (split TF32 on
// mma.sync m16n8k8): the warp's 16 keys (rows of ks, stored type TS, ld
// elements a row) by its NTW row tiles from n0: sacc[n] += K[16, kDS]
// q[rows, kDS]^T; qs: q's staged rows from the slice's first column (TQ,
// ldq elements a row).
template <typename TS, typename TQ, int NTW>
__device__ __forceinline__ void score_slice_f32(float (&sacc)[NTW][4],
                                                const TS* ks, int ld,
                                                const TQ* qs, int ldq,
                                                int n0, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < kDS; kk += 8) {
    const float a[4] = {to_f32(ks[g * ld + kk + t]),
                        to_f32(ks[(g + 8) * ld + kk + t]),
                        to_f32(ks[g * ld + kk + t + 4]),
                        to_f32(ks[(g + 8) * ld + kk + t + 4])};
    unsigned ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const TQ* qr = qs + (8 * (n0 + n) + g) * ldq + kk;
      const float bq[2] = {to_f32(qr[t]), to_f32(qr[t + 4])};
      anymma::mma_split_b(sacc[n], ah, al, bq);
    }
  }
}

// out^T += V^T P^T for the f32 compute type: the warp's 16 columns (from
// dm) of one V slice (the split's 64 keys, stored type TS, ld elements a
// row) by every row tile; P f32, a row every kSPP bytes.
template <typename TS, int NT>
__device__ __forceinline__ void pv_slice_f32(float (&acc)[NT][4],
                                             const TS* vs, int ld,
                                             const unsigned char* pbuf,
                                             int dm, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* pp = reinterpret_cast<const float*>(pbuf);
  constexpr int PP = kSPP / 4;
#pragma unroll 2
  for (int kk = 0; kk < kSplit; kk += 8) {
    const float a[4] = {to_f32(vs[(kk + t) * ld + dm + g]),
                        to_f32(vs[(kk + t) * ld + dm + g + 8]),
                        to_f32(vs[(kk + t + 4) * ld + dm + g]),
                        to_f32(vs[(kk + t + 4) * ld + dm + g + 8])};
    unsigned ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* pr = pp + (8 * n + g) * PP + kk;
      const float bp[2] = {pr[t], pr[t + 4]};
      anymma::mma_split_b(acc[n], ah, al, bp);
    }
  }
}

// D[64 x N] += A[64 x 16] B[16 x N] on the tensor cores (wgmma, N 8 / 16 /
// 32 / 64): A in registers, each warp of the warpgroup its 16 rows as the
// mma.sync m16n8k16 A fragment; B read from shared memory by descriptor,
// K-major with the 128-byte swizzle.  d[4 i + e] is column 8 i + 2 t + (e &
// 1) of the warp's row g + 8 (e >> 1), as the mma.sync C fragments of its
// n tiles.
template <int N>
__device__ __forceinline__ void wgmma_ra(float* d, const unsigned* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ra<8>(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ra<16>(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ra<32>(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ra<64>(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The byte offset of element (r, c) in a bf16 tile of R rows stored as
// 128-byte swizzled blocks of 64 columns (mma::sw128).
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return mma::sw128<R>(r, c);
}

// scores^T of one K slice for the bf16 compute type: the warpgroup's 64
// keys (the warp's 16 rows of ks: stored type TS, ld elements a row) by
// its NTW row tiles from n0, over the slice's kDS columns from d0 of q
// (qt: R rows, swizzled).  On wgmma (A the widened keys in registers, B
// q^T by descriptor).
template <typename TS, int R, int NTW>
__device__ __forceinline__ void score_slice_bf16(float (&sacc)[NTW][4],
                                                 const TS* ks, int ld,
                                                 const unsigned char* qt,
                                                 int d0, int n0, int g,
                                                 int t) {
  unsigned a[kDS / 16][4];
#pragma unroll
  for (int k = 0; k < kDS / 16; ++k) {
    const int kk = 16 * k;
    a[k][0] = pair_bf16(ks + g * ld + kk + 2 * t);
    a[k][1] = pair_bf16(ks + (g + 8) * ld + kk + 2 * t);
    a[k][2] = pair_bf16(ks + g * ld + kk + 8 + 2 * t);
    a[k][3] = pair_bf16(ks + (g + 8) * ld + kk + 8 + 2 * t);
  }
  mma::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kDS / 16; ++k)
    wgmma_ra<8 * NTW>(&sacc[0][0], a[k],
                      mma::smem_desc(qt + swz<R>(8 * n0, d0 + 16 * k), 16,
                                     1024));
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
}

// out^T += V^T P^T for the bf16 compute type: the warp's 16 columns (from
// dm) of one V slice (the split's 64 keys, stored type TS, ld elements a
// row) by every row tile; P as its bf16 hi and lo tiles (ph, pl: R rows of
// 64 keys, swizzled).  On wgmma (A the widened V^T in registers, B P^T by
// descriptor).
template <typename TS, int R, int NT>
__device__ __forceinline__ void pv_slice_bf16(float (&acc)[NT][4],
                                              const TS* vs, int ld,
                                              const unsigned char* ph,
                                              const unsigned char* pl,
                                              int dm, int lane) {
  const int g = lane >> 2, t = lane & 3;
  unsigned a[kSplit / 16][4];
#pragma unroll
  for (int k = 0; k < kSplit / 16; ++k) {
    const int kk = 16 * k;
    if constexpr (std::is_same<TS, bf16>::value) {
      anymma::load_a_trans_x4(a[k], vs, ld, kk, dm, lane);
    } else {  // int8 codes: (key, key + 1) of one column, widened
      const unsigned char* v0 = reinterpret_cast<const unsigned char*>(
          vs + (kk + 2 * t) * ld + dm + g);
      a[k][0] = widen2(v0[0] | (unsigned)v0[ld] << 8);
      a[k][1] = widen2(v0[8] | (unsigned)v0[ld + 8] << 8);
      a[k][2] = widen2(v0[8 * ld] | (unsigned)v0[9 * ld] << 8);
      a[k][3] = widen2(v0[8 * ld + 8] | (unsigned)v0[9 * ld + 8] << 8);
    }
  }
  mma::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kSplit / 16; ++k) {
    wgmma_ra<R>(&acc[0][0], a[k], mma::smem_desc(pl + 32 * k, 16, 1024));
    wgmma_ra<R>(&acc[0][0], a[k], mma::smem_desc(ph + 32 * k, 16, 1024));
  }
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
}

template <typename TQ, typename TH, typename TC, int NT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 2) score_any_kernel(Job j) {
  constexpr int R = 8 * NT;
  constexpr int MAXV = kAccTiles / NT;  // V slices a head-dim pass holds
  constexpr int NTW = NT >= 2 ? NT / 2 : 1;  // row tiles a warp scores
  constexpr bool kF32 = std::is_same<TC, float>::value;
  // the suffix (q's type) staged like the history where the types agree
  constexpr bool kSameType = std::is_same<TH, TQ>::value;
  // output items (a row's 4 columns) a thread merges: R x dc / kCluster /
  // 4 over the CTA's threads
  constexpr int kItems = kMaxRows * kAccTiles * kDS / 8 / kCluster / 4 /
                         kThreads;
  // the softmax: threads a row and keys a thread, the same at every row
  // count (a row's sum is reduced in one order whatever the CTA's rows)
  constexpr int kTPR = 4;
  constexpr int kKPT = kSplit / kTPR;
  extern __shared__ __align__(1024) unsigned char smraw[];
  __shared__ int prow[kMaxRows];  // pool row of each row, -1 dead
  __shared__ int mpos[kMaxRows];  // candidate / suffix index of each row
  __shared__ int rpass[kMaxRows];  // the pass of each row
  __shared__ long long qoff[kMaxRows];
  __shared__ float m_st[kMaxRows], l_st[kMaxRows], alpha_s[kMaxRows];
  __shared__ float self_s[kMaxRows], den_s[kMaxRows], es_s[kMaxRows];
  __shared__ float wgt[kCluster][kMaxRows];
  // the passes: a pass per distinct pool row among the rows, in the order
  // the rows first appear; each pass's length, this rank's history splits
  // and splits in all (the suffix's too, extend), scales
  __shared__ int p_row[kMaxRows], p_len[kMaxRows], p_nh[kMaxRows];
  __shared__ int p_jobs[kMaxRows];
  __shared__ float p_ch[kMaxRows], p_cv[kMaxRows];
  __shared__ int lead_s[kMaxRows];
  __shared__ int r_len[kMaxRows];
  __shared__ float r_ch[kMaxRows], r_cv[kMaxRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Geo& geo = j.geo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  long long y = blockIdx.x / kCluster;
  const int ht = (int)(y % geo.HT);
  y /= geo.HT;
  const int kvh = (int)(y % j.Hkv);
  y /= j.Hkv;
  const int c0 = (int)(y % geo.CGN) * geo.CG;
  const int b = (int)(y / geo.CGN);
  const int g0 = ht * geo.GR;
  const int col0 = blockIdx.y * geo.dc;
  const int ncols = min(geo.dc, j.D - col0);
  const int nK = geo.nK;
  const int nV = (ncols + kDS - 1) / kDS;
  const bool extend = j.mode == kExtend;
  const TQ* Q = static_cast<const TQ*>(j.q);
  // the regions from the first 1024-byte boundary (the swizzled tiles')
  unsigned char* sm =
      smraw + ((1024 - (mma::smem_addr(smraw) & 1023)) & 1023);
  unsigned char* qt = sm;  // q: swizzled (bf16 compute) or padded rows
  TQ* qsm = reinterpret_cast<TQ*>(sm);
  unsigned char* sp = sm + geo.q_bytes;
  unsigned char* ph = sp;  // P's bf16 hi and lo tiles, over the scores
  unsigned char* pl = sp + R * 128;
  unsigned char* ring = sp + geo.sp_bytes;
  float* state = reinterpret_cast<float*>(sm);  // after the splits
#ifdef SCORE_ANY_CLOCK
  const bool clk_on = threadIdx.x == 0 && (blockIdx.x == 0 ||
                                           blockIdx.x + 1 == gridDim.x);
  long long clk_t = clock64();
#endif

  auto cand = [&](int r) { return c0 + r / geo.GR; };
  auto head = [&](int r) { return kvh * geo.G + g0 + r % geo.GR; };
  if (tid < R) {
    const bool live = tid < geo.CG * geo.GR && cand(tid) < j.M &&
                      g0 + tid % geo.GR < geo.G;
    const int m = cand(tid);
    const int row = !live ? -1
                    : j.packed ? j.row_index[(long long)b * j.M + m]
                    : j.row_index ? j.row_index[b] : b;
    prow[tid] = row;
    // the row's pool-row length and scales, read at once (its pass's lead
    // row's become the pass's)
    const int rr = max(row, 0);
    r_len[tid] = j.lengths ? min(max(j.lengths[rr], 0), j.S) : j.S;
    r_ch[tid] = j.scale * (j.ks ? j.ks[rr * j.Hkv + kvh] : 1.f);
    r_cv[tid] = j.vs ? j.vs[rr * j.Hkv + kvh] : 1.f;
    mpos[tid] = m;
    qoff[tid] = live ? b * j.qs.n + (long long)m * j.qs.s +
                           (long long)head(tid) * j.qs.h
                     : 0;
    m_st[tid] = kNegInf;
    l_st[tid] = 0.f;
    self_s[tid] = kNegInf;
  }
  __syncthreads();
  // q of every live row, all of D, once (with the first stage's copies)
  auto q_off = [&](int r) { return qoff[r]; };
  auto q_live = [&](int r) { return prow[r] >= 0; };
  if constexpr (kF32)
    stage<TQ>([&](int r, int c) {
      return qt + (r * geo.qp + c) * (int)sizeof(TQ);
    }, R, Q, q_off, q_live, 0, j.D, nK * kDS);
  else
    stage<TQ>([&](int r, int c) { return qt + swz<R>(r, c); }, R, Q, q_off,
              q_live, 0, j.D, nK * kDS);
  // suffix splits some row of the group sees (the keys before its own,
  // which the merge takes last), and this rank's of them
  const int nsuf =
      extend ? (min(j.M, c0 + geo.CG) - 1 + kSplit - 1) / kSplit : 0;
  const int ns_mine = nsuf > rank ? (nsuf - rank + kCluster - 1) / kCluster
                                  : 0;
  SCORE_ANY_TICK("init + q copies issued");
  // each row's first row of its pool row (its pass's lead); the passes
  // are the leads, in row order
  if (tid < R) {
    int lead = -1;
    if (prow[tid] >= 0) {
      lead = 0;
      while (prow[lead] != prow[tid]) ++lead;
    }
    lead_s[tid] = lead;
  }
  __syncthreads();
  if (tid < R) {
    const int lead = lead_s[tid];
    int p = -1;
    if (lead >= 0) {
      p = 0;
      for (int r = 0; r < lead; ++r) p += lead_s[r] == r;
    }
    rpass[tid] = p;
    if (lead == tid) {
      const int hs = (r_len[tid] + kSplit - 1) / kSplit;
      const int nh = hs > rank ? (hs - rank + kCluster - 1) / kCluster : 0;
      p_row[p] = prow[tid];
      p_len[p] = r_len[tid];
      p_nh[p] = nh;
      p_jobs[p] = nh + ns_mine;  // extend: one pass, the suffix after it
      p_ch[p] = r_ch[tid];
      p_cv[p] = r_cv[tid];
    }
  }
  const int np = __syncthreads_count(tid < R && lead_s[tid] == tid);
  SCORE_ANY_TICK("passes");

  float acc[MAXV][NT][4];
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[v][n][e] = 0.f;

  const int km = warp & 3;   // scores: the warp's 16 keys
  const int nh = warp >> 2;  // scores: the warp's half of the row tiles
  const bool scorer = NT >= 2 || nh == 0;
  const int n0 = NT >= 2 ? nh * NTW : 0;
  const int per = nK + nV;  // ring stages a split
  const int hold = geo.slots - 1;
  int jobs = 0;
  for (int p = 0; p < np; ++p) jobs += p_jobs[p];
  const int nst = jobs * per;

  // A cursor over this rank's splits, pass after pass: (pass, split of the
  // pass, stage of the split).
  struct Cursor {
    int p, li, sub;
  };
  auto first = [&]() {
    Cursor c{0, 0, 0};
    while (c.p < np && p_jobs[c.p] == 0) ++c.p;
    return c;
  };
  auto next = [&](Cursor& c) {
    if (++c.sub < per) return;
    c.sub = 0;
    if (++c.li < p_jobs[c.p]) return;
    c.li = 0;
    do ++c.p;
    while (c.p < np && p_jobs[c.p] == 0);
  };
  // a split's first key and its end
  auto split_keys = [&](const Cursor& c, int& klo, int& khi, bool& hist) {
    hist = c.li < p_nh[c.p];
    klo = (rank + (hist ? c.li : c.li - p_nh[c.p]) * kCluster) * kSplit;
    khi = hist ? min(p_len[c.p], klo + kSplit) : min(j.M, klo + kSplit);
  };
  Cursor lc = first();  // the copies' cursor, hold stages ahead
  auto issue = [&](int st) {
    int klo, khi;
    bool hist;
    split_keys(lc, klo, khi, hist);
    const bool is_k = lc.sub < nK;
    const int d0 = is_k ? lc.sub * kDS : col0 + (lc.sub - nK) * kDS;
    unsigned char* dst = ring + (st % geo.slots) * geo.slot_bytes;
    if (hist) {
      const Strides& ss = is_k ? j.khs : j.vhs;
      const long long kb = p_row[lc.p] * ss.n + kvh * ss.h;
      stage<TH>([&](int r, int c) {
        return dst + r * geo.pitch_h + c * (int)sizeof(TH);
      }, kSplit, static_cast<const TH*>(is_k ? j.kh : j.vh),
                [&](int r) { return kb + (long long)(klo + r) * ss.s; },
                [&](int r) { return klo + r < khi; }, d0, j.D, kDS);
    } else {
      const Strides& ss = is_k ? j.kcs : j.vcs;
      const long long kb = b * ss.n + kvh * ss.h;
      stage<TQ>([&](int r, int c) {
        return dst + r * geo.pitch_q + c * (int)sizeof(TQ);
      }, kSplit, static_cast<const TQ*>(is_k ? j.kc : j.vc),
                [&](int r) { return kb + (long long)(klo + r) * ss.s; },
                [&](int r) { return klo + r < khi; }, d0, j.D, kDS);
    }
    next(lc);
  };
  for (int s = 0; s < hold; ++s) {
    if (s < nst) issue(s);
    mma::cp_async_commit();
  }
  // stage st's slot, once every thread is past stage st - 1; the copy
  // of stage st + slots - 1 then starts into the slot st - 1 freed
  auto advance = [&](int st) {
    wait_pending(geo.slots - 2);
    if constexpr (!kF32) mma::fence_async_smem();  // q, read by wgmma
    __syncthreads();
    if (st + hold < nst) issue(st + hold);
    mma::cp_async_commit();
    return ring + (st % geo.slots) * geo.slot_bytes;
  };

  Cursor cc = first();  // the products' cursor, a split at a time
  for (int jb = 0; jb < jobs; ++jb) {
    int klo, khi;
    bool hist;
    split_keys(cc, klo, khi, hist);
    const int pass = cc.p;
    const bool as_hist = hist || kSameType;  // the slot's stored type
    const float c_score = hist ? p_ch[pass] : j.scale;
    const int st0 = jb * per;
    // ---- scores^T [kSplit, R] = K q^T over the whole head dim ----
    float sacc[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
    for (int ks = 0; ks < nK; ++ks) {
      const unsigned char* slot = advance(st0 + ks);
      if (!scorer) continue;
      const int ldh = geo.pitch_h / (int)sizeof(TH);
      const int ldq = geo.pitch_q / (int)sizeof(TQ);
      const TH* kh = reinterpret_cast<const TH*>(slot) + km * 16 * ldh;
      const TQ* kq = reinterpret_cast<const TQ*>(slot) + km * 16 * ldq;
      if constexpr (kF32) {
        if (as_hist)
          score_slice_f32<TH, TQ, NTW>(sacc, kh, ldh, qsm + ks * kDS,
                                       geo.qp, n0, g, t);
        else
          score_slice_f32<TQ, TQ, NTW>(sacc, kq, ldq, qsm + ks * kDS,
                                       geo.qp, n0, g, t);
      } else {
        if (as_hist)
          score_slice_bf16<TH, R, NTW>(sacc, kh, ldh, qt, ks * kDS, n0, g,
                                       t);
        else
          score_slice_bf16<TQ, R, NTW>(sacc, kq, ldq, qt, ks * kDS, n0, g,
                                       t);
      }
    }
    SCORE_ANY_TICK("scores");
    if (scorer) {
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * (n0 + n) + 2 * t + (e & 1);
          const int key = km * 16 + g + 8 * (e >> 1);
          reinterpret_cast<float*>(sp + r * kSPP)[key] = sacc[n][e];
        }
    }
    __syncthreads();
    // ---- fold the split's softmax into each row's state: kTPR threads a
    // row, thread q its kKPT consecutive keys from kKPT q, reduced across
    // the row's threads in a fixed order; exponentials as 2^x of x log2(e)
    // on the special-function unit; a row with no key here keeps its
    // state.  P takes the scores' bytes once every thread has read its
    // scores ----
    const bool srow_on = tid < kTPR * R;
    const int sr = tid / kTPR, q4 = tid % kTPR;
    float s[kKPT];
    float alpha = 1.f, m_new = 0.f, sum = 0.f;
    bool any = false;
    if (srow_on) {
      const bool on = rpass[sr] == pass;
      const float* srow =
          reinterpret_cast<const float*>(sp + sr * kSPP) + kKPT * q4;
      const float m_old = m_st[sr];
      const int kbase = klo + kKPT * q4;
      const int kend = hist ? khi : min(khi, mpos[sr]);
      any = on && klo < kend;  // the row sees a key here
#pragma unroll
      for (int e = 0; e < kKPT; e += 2) {
        const float2 x = *reinterpret_cast<const float2*>(srow + e);
        s[e] = x.x;
        s[e + 1] = x.y;
      }
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < kKPT; ++e) {
        s[e] = any && kbase + e < kend ? s[e] * c_score : kNegInf;
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      m_new = any ? fmaxf(m_old, mx) : m_old;
      const float ml = m_new * kLog2e;
#pragma unroll
      for (int e = 0; e < kKPT; ++e) {
        s[e] = any && kbase + e < kend ? mma::ex2(fmaf(s[e], kLog2e, -ml))
                                       : 0.f;
        sum += s[e];
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha = any ? mma::ex2(fmaf(m_old, kLog2e, -ml)) : 1.f;
    }
    __syncthreads();
    if (srow_on) {
      if constexpr (kF32) {
        float* prow_f = reinterpret_cast<float*>(sp + sr * kSPP) + kKPT * q4;
#pragma unroll
        for (int e = 0; e < kKPT; e += 2)
          *reinterpret_cast<float2*>(prow_f + e) = make_float2(s[e], s[e + 1]);
      } else {  // 16-byte chunks of hi and of lo
#pragma unroll
        for (int c8 = 0; c8 < kKPT; c8 += 8) {
          unsigned hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            mma::split2(s[c8 + e], s[c8 + e + 1], hi[e / 2], lo[e / 2]);
          const int off = swz<R>(sr, kKPT * q4 + c8);
          *reinterpret_cast<uint4*>(ph + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(pl + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      if (!kF32) mma::fence_async_smem();  // P, read by wgmma
      if (q4 == 0) {
        alpha_s[sr] = alpha;
        if (any) {
          m_st[sr] = m_new;
          l_st[sr] = l_st[sr] * alpha + sum;
        }
      }
    }
    SCORE_ANY_TICK("softmax");
    // ---- out^T [D, R] = out^T alpha + V^T P^T, a warp 16 columns of
    // each slice ----
    const int dm = warp * 16;
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      if (v < nV) {
        const unsigned char* slot = advance(st0 + nK + v);
        if (v == 0) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float a0 = alpha_s[8 * n + 2 * t];
            const float a1 = alpha_s[8 * n + 2 * t + 1];
#pragma unroll
            for (int w = 0; w < MAXV; ++w) {
              acc[w][n][0] *= a0;
              acc[w][n][1] *= a1;
              acc[w][n][2] *= a0;
              acc[w][n][3] *= a1;
            }
          }
        }
        const int ldh = geo.pitch_h / (int)sizeof(TH);
        const int ldq = geo.pitch_q / (int)sizeof(TQ);
        const TH* vh = reinterpret_cast<const TH*>(slot);
        const TQ* vq = reinterpret_cast<const TQ*>(slot);
        if constexpr (kF32) {
          if (as_hist)
            pv_slice_f32<TH, NT>(acc[v], vh, ldh, sp, dm, lane);
          else
            pv_slice_f32<TQ, NT>(acc[v], vq, ldq, sp, dm, lane);
        } else {
          if (as_hist)
            pv_slice_bf16<TH, R, NT>(acc[v], vh, ldh, ph, pl, dm, lane);
          else
            pv_slice_bf16<TQ, R, NT>(acc[v], vq, ldq, ph, pl, dm, lane);
        }
      }
    }
    SCORE_ANY_TICK("pv");
    if (hist && cc.li == p_nh[pass] - 1 && j.vs) {  // the history's v scale
      const float cv = p_cv[pass];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float s0 = rpass[8 * n + 2 * t] == pass ? cv : 1.f;
        const float s1 = rpass[8 * n + 2 * t + 1] == pass ? cv : 1.f;
#pragma unroll
        for (int w = 0; w < MAXV; ++w) {
          acc[w][n][0] *= s0;
          acc[w][n][1] *= s1;
          acc[w][n][2] *= s0;
          acc[w][n][3] *= s1;
        }
      }
    }
    for (int s = 0; s < per; ++s) next(cc);
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  SCORE_ANY_TICK("drain");

  // ---- the own key's score of the rows r = rank (mod kCluster): q .
  // k_self (cached: the candidate's key; extend: the suffix key at the
  // row's own position), a warp a row, a lane CH consecutive columns of
  // every 32 x CH, summed in column order and then across the warp in a
  // fixed tree; the keys of a warp's rows loaded together (a dead row reads
  // candidate M - 1's and counts nothing).  The merge reads each row's from
  // its rank ----
  {
    constexpr int CH = 16 / (int)sizeof(TQ);
    constexpr int RPW = (R / kCluster + 7) / 8;  // rows a warp, at most
    const TQ* KC = static_cast<const TQ*>(j.kc);
    // whether every key row's chunks are 16-byte aligned
    const bool vec = j.D % CH == 0 &&
                     (reinterpret_cast<uintptr_t>(KC) & 15) == 0 &&
                     ((j.kcs.n | j.kcs.s | j.kcs.h) % CH) == 0;
    // the warp's i-th row (clamped: a warp past the rank's rows repeats
    // row R - 1 and writes nothing)
    auto mine = [&](int i) {
      return min(rank + kCluster * (warp + 8 * i), R - 1);
    };
    float dot[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
    for (int c = lane * CH; c < j.D; c += 32 * CH) {
      alignas(16) TQ kv[RPW][CH];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = mine(i);
        const TQ* kr = KC + b * j.kcs.n +
                       (long long)min(mpos[r], j.M - 1) * j.kcs.s +
                       (long long)kvh * j.kcs.h + c;
        if (vec) {
          *reinterpret_cast<uint4*>(kv[i]) =
              *reinterpret_cast<const uint4*>(kr);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e)
            kv[i][e] = c + e < j.D ? kr[e] : zero_of<TQ>();
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const TQ* qr =
            kF32 ? qsm + mine(i) * geo.qp + c
                 : reinterpret_cast<const TQ*>(qt + swz<R>(mine(i), c));
#pragma unroll
        for (int e = 0; e < CH; ++e)
          dot[i] = fmaf(to_f32(qr[e]), to_f32(kv[i][e]), dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], o);
      const int r = rank + kCluster * (warp + 8 * i);
      if (lane == 0 && r < R && prow[r] >= 0) self_s[r] = dot[i] * j.scale;
    }
  }
  SCORE_ANY_TICK("self scores");
  __syncthreads();  // q read: the accumulators take its place

  // ---- the CTA's accumulators to its shared memory, for the cluster ----
  {
    const int dm = warp * 16;
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      if (v < nV) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * n + 2 * t + (e & 1);
            const int d = v * kDS + dm + g + 8 * (e >> 1);
            if (d < ncols) state[r * geo.state_pitch + d] = acc[v][n][e];
          }
      }
    }
  }
  cluster.sync();
  SCORE_ANY_TICK("state + cluster sync");
  // ---- the merge in rank order: each row's max, weights, denominator ----
  if (tid < R && prow[tid] >= 0) {
    // the own key's score, from the rank that computed it
    const float ss = *cluster.map_shared_rank(&self_s[tid], tid % kCluster);
    float mx = ss;
    float mk[kCluster], lk[kCluster];
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      mk[k] = *cluster.map_shared_rank(&m_st[tid], k);
      lk[k] = *cluster.map_shared_rank(&l_st[tid], k);
    }
#pragma unroll
    for (int k = 0; k < kCluster; ++k)
      if (lk[k] > 0.f) mx = fmaxf(mx, mk[k]);
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      const float w = lk[k] > 0.f ? expf(mk[k] - mx) : 0.f;
      wgt[k][tid] = w;
      den += w * lk[k];
    }
    const float es = expf(ss - mx);
    es_s[tid] = es;
    den_s[tid] = fmaxf(den + es, 1e-30f);
  }
  __syncthreads();
  SCORE_ANY_TICK("weights");
  // ---- this CTA's share of the columns: every rank's sums in order, the
  // own key last, to the output; a thread's reads issued together ----
  {
    const int share = ((ncols + kCluster - 1) / kCluster + 3) / 4 * 4;
    const int lo = rank * share;
    const int hi = min(ncols, lo + share);
    const int q4 = hi > lo ? (hi - lo + 3) / 4 : 0;
    const TQ* VC = static_cast<const TQ*>(j.vc);
    TQ* O = static_cast<TQ*>(j.o);
    // whether every item's four columns are one aligned access: of the own
    // keys' values and of the output
    constexpr uintptr_t kQuad = 4 * sizeof(TQ) - 1;
    const bool whole = (hi - lo) % 4 == 0;
    const bool vvec = whole && (reinterpret_cast<uintptr_t>(VC) & kQuad) == 0 &&
                      ((j.vcs.n | j.vcs.s | j.vcs.h | col0) % 4) == 0;
    const bool ovec = whole && (reinterpret_cast<uintptr_t>(O) & kQuad) == 0 &&
                      ((j.os.n | j.os.s | j.os.h | col0) % 4) == 0;
    float4 x[kItems][kCluster];
    float vself[kItems][4];
    // every read issued before any is used: an item past the share reads
    // row 0's first columns, a dead row candidate M - 1's key, and neither
    // is written
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = min(tid + it * kThreads, max(R * q4 - 1, 0));
      const int r = i / max(q4, 1), c = lo + 4 * (i - r * max(q4, 1));
#pragma unroll
      for (int k = 0; k < kCluster; ++k)
        x[it][k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(
            state + r * geo.state_pitch + c, k));
      const TQ* vr = VC + b * j.vcs.n +
                     (long long)min(mpos[r], j.M - 1) * j.vcs.s +
                     (long long)kvh * j.vcs.h + col0;
      if (vvec) {
        load4(vr + c, vself[it]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vself[it][e] = to_f32(vr[min(c + e, max(hi - 1, 0))]);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / max(q4, 1), c = lo + 4 * (i - r * max(q4, 1));
      if (i >= R * q4 || prow[r] < 0) continue;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kCluster; ++k) {
        const float w = wgt[k][r];
        a[0] += w * x[it][k].x;
        a[1] += w * x[it][k].y;
        a[2] += w * x[it][k].z;
        a[3] += w * x[it][k].w;
      }
      const long long ob = b * j.os.n + (long long)mpos[r] * j.os.s +
                           (long long)head(r) * j.os.h + col0;
      const float es = es_s[r], den = den_s[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = (a[e] + es * vself[it][e]) / den;
      if (ovec) {
        store4(O + ob + c, a);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < hi) O[ob + c + e] = from_f32<TQ>(a[e]);
      }
    }
  }
  SCORE_ANY_TICK("output");
  cluster.sync();  // no CTA leaves while another reads its shared memory
  SCORE_ANY_TICK("last sync");
}

// The compute type: bf16 for bf16 q over an int8 or bf16 history, f32
// otherwise.
template <typename TQ, typename TH>
using Compute = typename std::conditional<
    std::is_same<TQ, bf16>::value && !std::is_same<TH, float>::value, bf16,
    float>::type;

using Kernel = void (*)(Job);

template <typename TQ, typename TH>
Kernel pick_nt(int NT) {
  using TC = Compute<TQ, TH>;
  switch (NT) {
    case 1: return score_any_kernel<TQ, TH, TC, 1>;
    case 2: return score_any_kernel<TQ, TH, TC, 2>;
    case 4: return score_any_kernel<TQ, TH, TC, 4>;
    default: return score_any_kernel<TQ, TH, TC, 8>;
  }
}

template <typename TQ>
Kernel pick_hist(int hist_dtype, int NT) {
  switch (hist_dtype) {
    case 0: return pick_nt<TQ, float>(NT);
    case 1: return pick_nt<TQ, bf16>(NT);
    default: return pick_nt<TQ, int8_t>(NT);
  }
}

inline Kernel pick(int q_dtype, int hist_dtype, int NT) {
  return q_dtype == 0 ? pick_hist<float>(hist_dtype, NT)
                      : pick_hist<bf16>(hist_dtype, NT);
}

inline int hist_size(int hist_dtype) {
  return hist_dtype == 0 ? 4 : hist_dtype == 1 ? 2 : 1;
}

// The kernel's dynamic shared bytes, with the SM's whole carveout as shared
// memory (two CTAs an SM need it).
inline cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
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

// K1 at any head dim (operand conventions of fused_score_fwd), one launch.
// q_dtype (q, k_cand, v_cand, o): 0 = float32, 1 = bfloat16.
// hist_dtype (k_hist, v_hist): 0 = float32, 1 = bfloat16, 2 = int8.
// k_scale / v_scale: [U, Hkv] f32 multipliers or NULL (= 1).
// row_index: [B] int32 pool row per batch row, [B, M] (packed != 0: a pool
// row per candidate, cached mode only) or NULL (= b).
// lengths: [U] int32 valid history prefix per pool row or NULL (= S).
// strides: 18 int64 -- (outer, seq, head) element strides of q, k_hist,
// v_hist, k_cand, v_cand, o.  scale multiplies the f32 scores.
// *launched: the kernels this call launched (1).
extern "C" int score_any_fwd(const void* q, const void* k_hist,
                             const void* v_hist, const float* k_scale,
                             const float* v_scale, const void* k_cand,
                             const void* v_cand, const int* row_index,
                             const int* lengths, void* o, int q_dtype,
                             int hist_dtype, int packed, int B, int M, int H,
                             int Hkv, int U, int S, int D,
                             const long long* strides, int mode, float scale,
                             void* stream, int* launched) {
  using namespace flame::score_any;
  if (!launched) return cudaErrorInvalidValue;
  *launched = 0;
  if (bad_shape(B, M, H, Hkv, U, S, D, mode, q_dtype, hist_dtype) ||
      (packed && (mode != kCached || !row_index)))
    return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.kh = k_hist; j.vh = v_hist; j.ks = k_scale; j.vs = v_scale;
  j.kc = k_cand; j.vc = v_cand; j.row_index = row_index; j.lengths = lengths;
  j.o = o;
  j.B = B; j.M = M; j.H = H; j.Hkv = Hkv; j.U = U; j.S = S; j.D = D;
  j.mode = mode; j.packed = packed;
  j.geo = geometry(B, M, H, Hkv, S, D, mode, q_dtype == 0 ? 4 : 2,
                   hist_size(hist_dtype));
  if (!fits(j.geo)) return cudaErrorInvalidValue;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  j.qs = st[0]; j.khs = st[1]; j.vhs = st[2]; j.kcs = st[3]; j.vcs = st[4];
  j.os = st[5];
  j.scale = scale;
  const Kernel kernel = pick(q_dtype, hist_dtype, j.geo.NT);
  cudaError_t err = prepare(kernel, j.geo.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)(j.geo.groups * kCluster), j.geo.passes),
           kThreads, j.geo.smem, static_cast<cudaStream_t>(stream)>>>(j);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return err;
}

// Launch plan: out = grid x (row groups x cluster), grid y (head-dim
// passes), CTAs a cluster, threads, dynamic shared bytes, rows a CTA,
// history splits, ring slots, CTAs resident an SM, clusters resident at
// once on this card, kernels a call (1), 1 if the products are bf16 (else
// split TF32).  Refuses what score_any_fwd refuses for its shapes.
extern "C" int score_any_plan(int q_dtype, int hist_dtype, int mode, int B,
                              int M, int H, int Hkv, int S, int D, int* out) {
  using namespace flame::score_any;
  if (bad_shape(B, M, H, Hkv, 1, S, D, mode, q_dtype, hist_dtype))
    return cudaErrorInvalidValue;
  const Geo g = geometry(B, M, H, Hkv, S, D, mode, q_dtype == 0 ? 4 : 2,
                         hist_size(hist_dtype));
  if (!fits(g)) return cudaErrorInvalidValue;
  const Kernel kernel = pick(q_dtype, hist_dtype, g.NT);
  cudaError_t err = prepare(kernel, g.smem);
  if (err != cudaSuccess) return err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, g.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.groups * kCluster), g.passes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.smem;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  out[0] = (int)(g.groups * kCluster);
  out[1] = g.passes;
  out[2] = kCluster;
  out[3] = kThreads;
  out[4] = g.smem;
  out[5] = 8 * g.NT;
  out[6] = g.hsplits;
  out[7] = g.slots;
  out[8] = blocks;
  out[9] = clusters;
  out[10] = 1;  // score_any_kernel
  out[11] = q_dtype == 1 && hist_dtype != 0;
  return cudaSuccess;
}
