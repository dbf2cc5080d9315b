// Any-dims fused (RMSNorm +) FFN for Hopper (sm_90a) on the tensor cores:
// the variant of kernel K3 (fused_ffn) that takes every model dim and d_ff
// its JAX wrapper takes.
//
// Replaces, at the dims the tiled kernels are not instantiated for, the
// Pallas TPU kernel repro/kernels/fused_ffn/kernel.py::fused_ffn_kernel
// (body _ffn_kernel), whose wrapper pads T and d_ff to its blocks and so
// takes any d and d_ff.  The wrapper (kernels/fused_ffn/ops.py: route)
// sends here, chosen from the dims before the launch: f32 operands at a
// model dim outside {64, 256}, and bf16 operands whose d or d_ff is not a
// multiple of 8 (the wide form's 16-byte rows).  Its launches count under
// fused_ffn_2d.
//
// It computes n(x) = x * rsqrt(mean(x^2) + 1e-6) * (1 + scale) (optional),
// h = act(n(x) W_up) (swiglu: silu(n(x) W_gate) * n(x) W_up), out = h W_down,
// accumulated in f32 and rounded to the operands' dtype once.
//
// Bound on an H100: operations past a few hundred rows (4 T d d_ff FLOPs, 6
// with a gate: at f32 d 1024, d_ff 4096, T 512 17 us at TF32's 495
// TFLOP/s), the weights' bytes below (at T 4 the same weights' 34 MB take
// 10 us at 3.35 TB/s).
//
// Design.  Two kernels:
//   1. ffn_any_kernel: a block owns R rows (64; 16 at T <= 64) and one
//      slice of d_ff (the wrapper picks the slices from T so that small T
//      still spreads over the SMs).  For each chunk of up to kChunk = 256
//      columns of its slice it runs the up (and gate) product in steps of
//      NC columns (64; 128 for f32 at 64 rows), the activation in the
//      registers that hold the product, and writes the [R, chunk] hidden
//      to shared memory (it never reaches device memory); then the down
//      product takes the hidden as its A operand, one kDN = 128-column tile
//      of the output at a time, accumulating in registers, and writes each
//      tile once to its slice's f32 partial [T, d] (a slice of more than
//      one chunk adds the later chunks' tiles to it).  Every operand tile
//      (x and the scale's slice, W_up / W_gate, W_down) streams through a
//      ring of shared-memory stages, which producer threads beside the 256
//      consumers fill by cp.async (256 of them at 16 rows a block, 128 at
//      64): 16 bytes where a row's address allows, else 8 or 4 (the odd
//      widths: d_ff 4100's rows are 8-byte aligned), else, for a bf16 row
//      of an odd pitch, element by element.  A stage's full barrier counts
//      the producers' copies landing (cp.async.mbarrier.arrive), its empty
//      barrier the consumer warps done with it.  Only the k edge of a
//      product is zero-filled; rows past T and columns past a chunk are
//      not copied at all.
//   2. ffn_any_reduce: out = the slices' partials summed in slice order.
// Products: f32 operands on mma.sync m16n8k8 TF32 as split hi + lo (three
// products each, any_mma.cuh: ~2^-21 of an operand lost), which keeps the
// f32 contract (1e-5) on the tensor cores.  bf16 operands (odd widths) on
// mma.sync m16n8k16, the weights exact and n(x) and the hidden as bf16 hi
// + lo (f32 to ~2^-17; without the norm x is exact and takes one product).
// Where the time goes (scripts/any_variants.py): each thread's cp.async
// issue is slow, so copies take many threads, and the producers keep them
// off the consumers; what is left is the products (mma.sync TF32, three an
// f32 product, at 64 rows) and, for the odd-width bf16 rows, the copies
// of 8 bytes.  Measurement builds only (that script's nvcc -D): with
// FFN_ANY_CUT_LOAD the stages are not copied, with FFN_ANY_CUT_MMA the
// products are not run (the results are then wrong), and with
// FFN_ANY_CLOCK block (0, 0)'s first consumer prints its cycles and those
// it waited for a stage's copies.
// Invariants: no atomics and fixed orders (the d_ff steps, the chunks, the
// slices), so two calls agree bitwise; the slices depend on T, d_ff and the
// dims alone.
#include <type_traits>
#ifdef FFN_ANY_CLOCK
#include <cstdio>
#endif

#include "any_mma.cuh"
#include "attention_common.cuh"

namespace flame {
namespace any_ffn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // consumers: 8 warps
constexpr int kChunk = 256;    // d_ff columns whose hidden a block holds
constexpr int kKD = 32;        // model dims a stage of the up product
constexpr int kKF = 32;        // d_ff columns a stage of the down product
constexpr int kDN = 128;       // output columns a down-product tile
constexpr int kCols = 32;      // slices are multiples of it
constexpr float kEps = 1e-6f;
constexpr int kStages = 3;     // ring stages
// d_ff columns an up-product step; f32 at 64 rows a block
constexpr int kStep = 64;
constexpr int kStepLargeF32 = 128;
// producer threads beside the 256 consumers, at 16 and 64 rows a block
// (384 threads at 64 rows keep the consumers' 168 registers)
constexpr int kProducersSmall = 256;
constexpr int kProducersLarge = 128;
// slices a thread of the reduction loads before it adds them
constexpr int kReduceBatch = 16;

enum Act { kGelu = 0, kRelu = 1, kSwiglu = 2 };

template <typename T, int MT>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int R = 16 * MT;  // rows a block
  static constexpr int NC = MT == 4 && kF32 ? kStepLargeF32 : kStep;
  static constexpr int XP = kKD + (kF32 ? 4 : 8);     // x tile pitch
  static constexpr int WP = NC + 8;                   // W_up / W_gate pitch
  static constexpr int DP = kDN + 8;                  // W_down pitch
  static constexpr int HP = kChunk + (kF32 ? 4 : 8);  // hidden pitch
  static constexpr int NS = kStages;
  static constexpr int P = MT == 1 ? kProducersSmall : kProducersLarge;
};

// Dynamic shared memory of a block of 16 MT rows: the ring (a stage is the
// up product's raw x tile and the scale's slice with its W_up and W_gate
// tiles, or the down product's W_down tile, all in the operands' dtype),
// then the hidden [R, kChunk] (f32, or bf16 hi and lo planes).
template <typename T, int MT>
struct Smem {
  using C = Cfg<T, MT>;
  static constexpr int x = ((C::R * C::XP + kKD) * (int)sizeof(T) + 15) /
                           16 * 16;
  static constexpr int w = kKD * C::WP * (int)sizeof(T);
  static constexpr int p1 = x + 2 * w;
  static constexpr int p2 = kKF * C::DP * (int)sizeof(T);
  static constexpr int slot = ((p1 > p2 ? p1 : p2) + 127) / 128 * 128;
  static constexpr int ring = C::NS * slot;
  static constexpr int hidden = C::R * C::HP * 4;
  static constexpr int total = ring + hidden;
};

__device__ __forceinline__ float act_of(int act, float up, float gate) {
  if (act == kSwiglu) return gate / (1.f + expf(-gate)) * up;
  if (act == kRelu) return fmaxf(up, 0.f);
  const float c = 0.7978845608028654f;  // sqrt(2 / pi): gelu, tanh form
  return 0.5f * up * (1.f + tanhf(c * (up + 0.044715f * up * up * up)));
}

// rows x cols of a row-major matrix (src: the tile's first element, pitch
// ld; origin: any valid address of the matrix) into shared memory of pitch
// ldd by cp.async, in 16-byte chunks: one copy where the address allows,
// else two of 8 bytes or four of 4, or (bf16 rows of an odd pitch) the
// elements loaded and stored one by one.  Elements past cols_valid in a
// chunk are zeros; rows past rows_valid and chunks past cols_valid are
// zero-filled where zero_rows / zero_cols (the product's k edge), else
// skipped: their shared memory keeps stale values, which reach only
// results the kernel never keeps (rows past T, hidden columns past the
// chunk, which the activation sets to 0).
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ldd, int rows,
                                           int cols, const T* src,
                                           long long ld, int rows_valid,
                                           int cols_valid, bool zero_rows,
                                           bool zero_cols, const T* origin,
                                           int self, int count) {
#ifdef FFN_ANY_CUT_LOAD
  return;
#endif
  constexpr int CH = 16 / (int)sizeof(T);
  const int per_row = cols / CH;
  const int rn = zero_rows ? rows : min(rows, rows_valid);
  const int cn = zero_cols ? cols : min(cols, cols_valid);
  for (int i = self; i < rn * per_row; i += count) {
    const int r = i / per_row, c = (i - r * per_row) * CH;
    if (c >= cn) continue;
    T* d = dst + r * ldd + c;
    const int n = r < rows_valid ? min(CH, cols_valid - c) : 0;
    if (n <= 0) {
      mma::cp_async16_zfill(d, origin, false);
      continue;
    }
    const T* s = src + r * ld + c;
    const uintptr_t at = reinterpret_cast<uintptr_t>(s);
    constexpr int E = (int)sizeof(T);
    if (n == CH && (at & 15) == 0) {
      mma::cp_async16(d, s);
    } else if ((at & 7) == 0) {
#pragma unroll
      for (int e = 0; e < CH; e += 8 / E)
        anymma::cp_async_zfill_n<8>(d + e, e < n ? s + e : origin,
                                    e < n ? E * min(8 / E, n - e) : 0);
    } else if ((at & 3) == 0) {
#pragma unroll
      for (int e = 0; e < CH; e += 4 / E)
        anymma::cp_async_zfill_n<4>(d + e, e < n ? s + e : origin,
                                    e < n ? E * min(4 / E, n - e) : 0);
    } else if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = e < n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// The products: f32 as split TF32, bf16 as one mma (none with
// FFN_ANY_CUT_MMA).
__device__ __forceinline__ void product_tf32(float* c, const unsigned* ah,
                                             const unsigned* al,
                                             const float* b) {
#ifndef FFN_ANY_CUT_MMA
  anymma::mma_split_b(c, ah, al, b);
#endif
}
__device__ __forceinline__ void product_bf16(float* c, const unsigned* a,
                                             const unsigned* b) {
#ifndef FFN_ANY_CUT_MMA
  mma::mma_bf16(c, a, b);
#endif
}

// A bf16 pair (the lower column in the low half) as two f32.
__device__ __forceinline__ float lo_of(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_of(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads + Cfg<T, MT>::P)
    ffn_any_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ w_up, const T* __restrict__ w_gate,
                   const T* __restrict__ w_down, float* __restrict__ part,
                   int Tn, int d, int F, int act, int slice_cols) {
  using C = Cfg<T, MT>;
  using L = Smem<T, MT>;
  constexpr bool kF32 = C::kF32;
  constexpr int R = C::R;
  constexpr int kNC = C::NC;
  constexpr int WN = 8 / MT;         // warps along n
  constexpr int NT1 = kNC / 8 / WN;  // up product: n tiles a warp
  constexpr int NT2 = kDN / 8 / WN;  // down product: n tiles a warp
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ float inv[R];
  // a ring slot's barriers: full (its copies landed: the producer lanes'
  // cp.async arrivals and plain arrivals), empty (the consumer warps are
  // done with it)
  __shared__ __align__(8) uint64_t full[C::NS], empty[C::NS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % MT, wn = warp / MT;
  const int r0 = blockIdx.x * R;
  const int f_lo = blockIdx.y * slice_cols;
  const int f_hi = min(F, f_lo + slice_cols);
  const bool gated = act == kSwiglu;
  const bool norm = scale != nullptr;
  unsigned char* hid = sm + L::ring;

#pragma unroll
  for (int s = 0; s < C::NS; ++s) {
    mma::mbar_init(&full[s], 2 * C::P, tid == 0);
    mma::mbar_init(&empty[s], kThreads / 32, tid == 0);
  }
  mma::fence_mbar_init();
  // rows' inverse RMS (1 without the norm): a consumer warp a row
  for (int r = warp; r < R && warp < kThreads / 32; r += kThreads / 32) {
    float ss = 0.f;
    if (norm && r0 + r < Tn)
      for (int c = lane; c < d; c += 32) {
        const float v = to_f32(x[(long long)(r0 + r) * d + c]);
        ss = fmaf(v, v, ss);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv[r] = norm ? rsqrtf(ss / d + kEps) : 1.f;
  }
  __syncthreads();

  float* out = part + (long long)blockIdx.y * Tn * d;  // the slice's partial
  const int nD = (d + kKD - 1) / kKD;
  const int nDN = (d + kDN - 1) / kDN;
  const int ar = mt * 16;  // the warp's rows
  const float iv0 = inv[ar + g], iv1 = inv[ar + g + 8];

  const bool producer = tid >= kThreads;
#ifdef FFN_ANY_CLOCK
  long long waited = 0;
  const long long start = clock64();
#endif
  const int ptid = tid - kThreads;  // a producer's index
  int G = 0;  // stages so far: the ring slot G % NS, its use G / NS
  for (int fc = f_lo, first = 1; fc < f_hi; fc += kChunk, first = 0) {
    const int cc = min(kChunk, f_hi - fc);  // this chunk's columns
    const int nsub = (cc + kNC - 1) / kNC;
    const int nF = (cc + kKF - 1) / kKF;
    const int P1 = nsub * nD;
    const int nst = P1 + nDN * nF;

    if (producer) {
      // the producer warp: each stage's tiles by cp.async into the slot
      // the consumers have released, then the slot's full barrier
      for (int st = 0; st < nst; ++st, ++G) {
        const int sl = G % C::NS;
        if (G >= C::NS) mma::mbar_wait(&empty[sl], (G / C::NS - 1) & 1);
        unsigned char* base = sm + sl * L::slot;
        if (st < P1) {
          const int k0 = (st % nD) * kKD, n0 = fc + (st / nD) * kNC;
          T* xs = reinterpret_cast<T*>(base);
          T* wu = reinterpret_cast<T*>(base + L::x);
          // x: rows past T skipped, columns past d zeros; the scale's
          // columns past d zeros; W: rows past d zeros, columns past the
          // chunk skipped
          stage_tile<T>(xs, C::XP, R, kKD, x + (long long)r0 * d + k0, d,
                        Tn - r0, d - k0, false, true, x, ptid, C::P);
          if (norm)
            stage_tile<T>(xs + R * C::XP, kKD, 1, kKD, scale + k0, 0, 1,
                          d - k0, true, true, scale, ptid, C::P);
          stage_tile<T>(wu, C::WP, kKD, kNC, w_up + (long long)k0 * F + n0,
                        F, d - k0, fc + cc - n0, true, false, w_up, ptid,
                        C::P);
          if (gated)
            stage_tile<T>(wu + kKD * C::WP, C::WP, kKD, kNC,
                          w_gate + (long long)k0 * F + n0, F, d - k0,
                          fc + cc - n0, true, false, w_gate, ptid, C::P);
        } else {
          const int u = st - P1;
          const int k0 = fc + (u % nF) * kKF, n0 = (u / nF) * kDN;
          // W_down: rows past the chunk zeros, columns past d skipped
          stage_tile<T>(reinterpret_cast<T*>(base), C::DP, kKF, kDN,
                        w_down + (long long)k0 * d + n0, d, fc + cc - k0,
                        d - n0, true, false, w_down, ptid, C::P);
        }
        // arrives when this lane's copies land; the plain arrival
        // releases its element stores (odd-pitch bf16 rows)
        anymma::cp_async_mbar_arrive(&full[sl]);
        mma::mbar_arrive(&full[sl], 1);
      }
      continue;
    }

    float up[NT1][4], gt[NT1][4], oacc[NT2][4];
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) up[n][e] = gt[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

    for (int st = 0; st < nst; ++st, ++G) {
      const int sl = G % C::NS;
#ifdef FFN_ANY_CLOCK
      const long long w0 = clock64();
#endif
      mma::mbar_wait(&full[sl], (G / C::NS) & 1);
#ifdef FFN_ANY_CLOCK
      waited += clock64() - w0;
#endif
      const unsigned char* base = sm + sl * L::slot;
      if (st < P1) {
        // ---- up (and gate) product: [R, kNC] += n(x) W over kKD ----
        const T* xs = reinterpret_cast<const T*>(base);
        const T* sc = xs + R * C::XP;
        const T* wu = reinterpret_cast<const T*>(base + L::x);
        const T* wg = wu + kKD * C::WP;
        const T* x0 = xs + (ar + g) * C::XP;
        const T* x1 = x0 + 8 * C::XP;
        if constexpr (kF32) {
#pragma unroll
          for (int kk = 0; kk < kKD; kk += 8) {
            const float s0 = norm ? 1.f + sc[kk + t] : 1.f;
            const float s1 = norm ? 1.f + sc[kk + t + 4] : 1.f;
            const float a[4] = {x0[kk + t] * iv0 * s0, x1[kk + t] * iv1 * s0,
                                x0[kk + t + 4] * iv0 * s1,
                                x1[kk + t + 4] * iv1 * s1};
            unsigned ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
            for (int n = 0; n < NT1; ++n) {
              const int col = (wn * NT1 + n) * 8 + g;
              const float bu[2] = {wu[(kk + t) * C::WP + col],
                                   wu[(kk + t + 4) * C::WP + col]};
              product_tf32(up[n], ah, al, bu);
              if (gated) {
                const float bg[2] = {wg[(kk + t) * C::WP + col],
                                     wg[(kk + t + 4) * C::WP + col]};
                product_tf32(gt[n], ah, al, bg);
              }
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kKD; kk += 16) {
            // n(x) as bf16 hi + lo from the raw pairs (x itself without
            // the norm: exact in bf16, one product)
            unsigned ah[4], al[4];
            const int cols[2] = {kk + 2 * t, kk + 8 + 2 * t};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned p0 = mma::ld32(x0 + cols[h]);
              const unsigned p1 = mma::ld32(x1 + cols[h]);
              if (norm) {
                const unsigned sp = mma::ld32(sc + cols[h]);
                const float sa = 1.f + lo_of(sp), sb = 1.f + hi_of(sp);
                mma::split2(lo_of(p0) * iv0 * sa, hi_of(p0) * iv0 * sb,
                            ah[2 * h], al[2 * h]);
                mma::split2(lo_of(p1) * iv1 * sa, hi_of(p1) * iv1 * sb,
                            ah[2 * h + 1], al[2 * h + 1]);
              } else {
                ah[2 * h] = p0;
                ah[2 * h + 1] = p1;
              }
            }
            if constexpr (NT1 == 1) {
              unsigned b[2];
              anymma::load_b_trans_x2(b, wu, C::WP, kk, wn * 8, lane);
              if (norm) product_bf16(up[0], al, b);
              product_bf16(up[0], ah, b);
              if (gated) {
                anymma::load_b_trans_x2(b, wg, C::WP, kk, wn * 8, lane);
                if (norm) product_bf16(gt[0], al, b);
                product_bf16(gt[0], ah, b);
              }
            } else {
#pragma unroll
              for (int n = 0; n < NT1; n += 2) {
                unsigned b[4];
                const int col = (wn * NT1 + n) * 8;
                mma::load_b_trans_x4(b, wu, C::WP, kk, col, lane);
                if (norm) {
                  product_bf16(up[n], al, b);
                  product_bf16(up[n + 1], al, b + 2);
                }
                product_bf16(up[n], ah, b);
                product_bf16(up[n + 1], ah, b + 2);
                if (gated) {
                  mma::load_b_trans_x4(b, wg, C::WP, kk, col, lane);
                  if (norm) {
                    product_bf16(gt[n], al, b);
                    product_bf16(gt[n + 1], al, b + 2);
                  }
                  product_bf16(gt[n], ah, b);
                  product_bf16(gt[n + 1], ah, b + 2);
                }
              }
            }
          }
        }
        if (st % nD == nD - 1) {
          // the activation, from the product's registers to the hidden
          const int sub = st / nD;
#pragma unroll
          for (int n = 0; n < NT1; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = ar + g + 8 * (e >> 1);
              const int c = sub * kNC + (wn * NT1 + n) * 8 + 2 * t + (e & 1);
              const float h = c < cc ? act_of(act, up[n][e], gt[n][e]) : 0.f;
              if constexpr (kF32) {
                reinterpret_cast<float*>(hid)[r * C::HP + c] = h;
              } else {
                bf16* hh = reinterpret_cast<bf16*>(hid);
                const bf16 hi = __float2bfloat16(h);
                hh[r * C::HP + c] = hi;
                hh[R * C::HP + r * C::HP + c] =
                    __float2bfloat16(h - __bfloat162float(hi));
              }
              up[n][e] = gt[n][e] = 0.f;
            }
          }
          // every warp's hidden columns are written before any reads them
          if (st == P1 - 1) mma::bar_sync(1, kThreads);
        }
      } else {
        // ---- down product: [R, kDN] += hidden W_down over kKF ----
        const int u = st - P1;
        const int hk = (u % nF) * kKF;  // hidden column of the stage
        if constexpr (kF32) {
          const float* hs = reinterpret_cast<const float*>(hid);
          const float* wd = reinterpret_cast<const float*>(base);
#pragma unroll
          for (int kk = 0; kk < kKF; kk += 8) {
            const float* h0 = hs + (ar + g) * C::HP + hk + kk;
            const float* h1 = h0 + 8 * C::HP;
            const float a[4] = {h0[t], h1[t], h0[t + 4], h1[t + 4]};
            unsigned ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) anymma::split(a[e], ah[e], al[e]);
#pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int col = (wn * NT2 + n) * 8 + g;
              const float b[2] = {wd[(kk + t) * C::DP + col],
                                  wd[(kk + t + 4) * C::DP + col]};
              product_tf32(oacc[n], ah, al, b);
            }
          }
        } else {
          const bf16* hh = reinterpret_cast<const bf16*>(hid);
          const bf16* hl = hh + R * C::HP;
          const bf16* wd = reinterpret_cast<const bf16*>(base);
#pragma unroll
          for (int kk = 0; kk < kKF; kk += 16) {
            unsigned ah[4], al[4];
            mma::load_a_x4(ah, hh, C::HP, ar, hk + kk, lane);
            mma::load_a_x4(al, hl, C::HP, ar, hk + kk, lane);
#pragma unroll
            for (int n = 0; n < NT2; n += 2) {
              unsigned b[4];
              mma::load_b_trans_x4(b, wd, C::DP, kk, (wn * NT2 + n) * 8,
                                   lane);
              product_bf16(oacc[n], al, b);
              product_bf16(oacc[n + 1], al, b + 2);
              product_bf16(oacc[n], ah, b);
              product_bf16(oacc[n + 1], ah, b + 2);
            }
          }
        }
        if (u % nF == nF - 1) {
          // the tile's rows of the slice's partial: set by the first
          // chunk, added to by the later ones
          const int n0 = (u / nF) * kDN;
#pragma unroll
          for (int n = 0; n < NT2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + ar + g + 8 * (e >> 1);
              const int c = n0 + (wn * NT2 + n) * 8 + 2 * t + (e & 1);
              if (r < Tn && c < d) {
                float* o = out + (long long)r * d + c;
                *o = first ? oacc[n][e] : *o + oacc[n][e];
              }
              oacc[n][e] = 0.f;
            }
          }
        }
      }
      __syncwarp();  // the warp is done with the slot
      mma::mbar_arrive(&empty[sl], lane == 0);
    }
    // the hidden is read before the next chunk's activation writes it
    mma::bar_sync(1, kThreads);
  }
#ifdef FFN_ANY_CLOCK
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    printf("[clock] R %d T %d: total %lld wait %lld\n", R, Tn,
           clock64() - start, waited);
#endif
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffn_any_reduce(const float* __restrict__ part, T* __restrict__ out,
                   long long n, int slices) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;  // in slice order; kReduceBatch loads in flight
  for (int k0 = 0; k0 < slices; k0 += kReduceBatch) {
    float v[kReduceBatch];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u)
      v[u] = k0 + u < slices ? part[(k0 + u) * n + i] : 0.f;
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u)
      if (k0 + u < slices) s += v[u];
  }
  out[i] = from_f32<T>(s);
}

// Launches the FFN kernel and the reduction; *launched counts the kernels
// launched.
template <typename T, int MT>
cudaError_t launch(const void* x, const void* scale, const void* w_up,
                   const void* w_gate, const void* w_down, void* out,
                   float* part, int Tn, int d, int F, int act, int slice_cols,
                   cudaStream_t stream, int* launched) {
  constexpr int bytes = Smem<T, MT>::total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_any_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  const int slices = (F + slice_cols - 1) / slice_cols;
  constexpr int R = 16 * MT;
  ffn_any_kernel<T, MT><<<dim3((Tn + R - 1) / R, slices),
                          kThreads + Cfg<T, MT>::P, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(w_up), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_down), part, Tn, d, F, act, slice_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const long long n = (long long)Tn * d;
  ffn_any_reduce<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(part, static_cast<T*>(out), n, slices);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
int smem_of(int rows) {
  return rows == 16 ? Smem<T, 1>::total : Smem<T, 4>::total;
}

template <typename T>
int producers_of(int rows) {
  return rows == 16 ? Cfg<T, 1>::P : Cfg<T, 4>::P;
}

template <typename T>
int stages_of(int rows) {
  return rows == 16 ? Cfg<T, 1>::NS : Cfg<T, 4>::NS;
}

}  // namespace any_ffn
}  // namespace flame

static bool bad_args(int T, int d, int F, int act, int rows, int slice_cols,
                     bool gated) {
  using namespace flame::any_ffn;
  return T <= 0 || d <= 0 || F <= 0 || act < kGelu || act > kSwiglu ||
         (act == kSwiglu) != gated || (rows != 16 && rows != 64) ||
         slice_cols <= 0 || slice_cols % kCols ||
         (F + slice_cols - 1) / slice_cols > 65535 ||
         (T + rows - 1) / rows > 0x7fffffff;
}

// dtype: 0 = float32, 1 = bfloat16 (every operand).  x [T, d], scale [d] or
// null, w_up / w_gate [d, F] (w_gate null unless act = swiglu), w_down
// [F, d], out [T, d], all row-major; part: the f32 workspace [ceil(F /
// slice_cols), T, d]; rows a block: 16 or 64; slice_cols a multiple of 32.
// *launched: the kernels this call launched.
extern "C" int ffn_any_fwd(const void* x, const void* scale, const void* w_up,
                           const void* w_gate, const void* w_down, void* out,
                           void* part, int dtype, int T, int d, int F, int act,
                           int rows, int slice_cols, void* stream,
                           int* launched) {
  using namespace flame::any_ffn;
  if (!launched) return cudaErrorInvalidValue;
  *launched = 0;
  if (bad_args(T, d, F, act, rows, slice_cols, w_gate != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return rows == 16
               ? launch<float, 1>(x, scale, w_up, w_gate, w_down, out, p, T,
                                  d, F, act, slice_cols, s, launched)
               : launch<float, 4>(x, scale, w_up, w_gate, w_down, out, p, T,
                                  d, F, act, slice_cols, s, launched);
  if (dtype == 1)
    return rows == 16
               ? launch<__nv_bfloat16, 1>(x, scale, w_up, w_gate, w_down,
                                          out, p, T, d, F, act, slice_cols,
                                          s, launched)
               : launch<__nv_bfloat16, 4>(x, scale, w_up, w_gate, w_down,
                                          out, p, T, d, F, act, slice_cols,
                                          s, launched);
  return cudaErrorInvalidValue;
}

// Launch plan: out = grid x (row tiles), grid y (slices), threads, dynamic
// shared bytes, ring stages, chunk columns, reduce blocks.
extern "C" int ffn_any_plan(int dtype, int T, int d, int F, int act, int rows,
                            int slice_cols, int* out) {
  using namespace flame::any_ffn;
  if (bad_args(T, d, F, act, rows, slice_cols, act == kSwiglu) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  out[0] = (T + rows - 1) / rows;
  out[1] = (F + slice_cols - 1) / slice_cols;
  out[2] = kThreads + (dtype == 0 ? producers_of<float>(rows)
                                  : producers_of<__nv_bfloat16>(rows));
  out[3] = dtype == 0 ? smem_of<float>(rows) : smem_of<__nv_bfloat16>(rows);
  out[4] = dtype == 0 ? stages_of<float>(rows)
                      : stages_of<__nv_bfloat16>(rows);
  out[5] = kChunk;
  out[6] = (int)(((long long)T * d + kThreads - 1) / kThreads);
  return cudaSuccess;
}
