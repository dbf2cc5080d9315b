// Chunked RWKV-6 wkv scan for Hopper (sm_90a) — kernel K5 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel (body _wkv_kernel).  It computes the same function: per
// (row b, head h), with w = exp(w_log) per step and channel,
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t S_{t-1} + (r_t.(u*k_t)) v_t
// in chunks of kC = 64 steps.  Inside a chunk, with la the inclusive
// cumulative sum of w_log over the chunk's steps and la_prev = la - w_log
// (as the reference forms it):
//   o[t] = (r[t] e^{la_prev[t]}) S + sum_{s<t} sc[t,s] v[s] + (r[t].(u*k[t])) v[t]
//   sc[t,s] = sum_d r[t,d] k[s,d] e^{la_prev[t,d] - la[s,d]}
//   S'   = diag(e^{la_c}) S + sum_s (k[s] e^{la_c - la[s]}) v[s]^T
// with la_c = la at the chunk's last step.
//
// Sub-chunk factored decays.  The chunk splits into kSub sub-chunks of kL =
// 16 steps.  With B_j = la at the last step of sub-chunk j and A_i =
// B_{i-1} (A_0 = 0), every decay factors through sub-chunk boundaries:
//   Q[t] = r[t] e^{la_prev[t] - A_i}  (t in sub-chunk i)
//   K[s] = k[s] e^{B_j - la[s]}       (s in sub-chunk j)
//   sc[t,s] = sum_d Q[t,d] e^{A_i[d] - B_j[d]} K[s,d]   (j < i)
//   r[t] e^{la_prev[t]} = Q[t] e^{A_i},  k[s] e^{la_c - la[s]} = K[s] e^{la_c - B_j}
// Every exponent is <= 0 (la never increases), so a factor underflows to 0
// only where the product it belongs to underflows too, and the form stays
// finite under runs of w_log = -20, where a chunk's decay reaches -1280 and
// the factoring through e^{-la} would give 0 x inf.  Only the 4 diagonal
// 16 x 16 blocks of sc keep the pairwise e^{la_prev[t] - la[s]}: 480 x D
// exponentials a chunk where the pairwise form takes 2016 x D, plus 2 x 64 x
// D for Q and K and 10 x D per-channel scalars.
//
// Tensor cores.  The products of a chunk run on mma.sync.m16n8k8 TF32 with
// f32 accumulation: the off-diagonal blocks of sc (Q e^{A_i - B_j} K^T), r_dec
// S, sc v and k_dec^T v.  An operand that TF32 does not hold exactly (the
// decayed r and k, the f32 state, the scores, f32 v) enters as hi + lo (hi
// rounded to TF32 by cvt.rna, lo the remainder, whose low 13 bits the tensor
// core ignores: ~2^-20 of the value is lost), and a product takes hi*hi +
// hi*lo + lo*hi; bf16 v is exact in TF32 and takes two.  That keeps the f32
// path within 1e-4 of the plain version, where bf16 hi + lo (~2^-17) would
// not.  The state stays f32 in shared memory for the whole
// sequence.
//
// Phases of a chunk, 256 threads, a barrier after each: P1 la and la_prev
// (one thread per channel) and the per-channel scalars; P2 the diagonal
// blocks of sc in 4 x 4 register tiles (every warp; lanes split the
// channels); P3 Q and K in place of la_prev and la; P4 the off-diagonal
// blocks of sc (one 16 x 16 block a warp); P5 o (each warp two
// sub-chunks' rows, so the sc v work is even) and k_dec^T v into
// registers; P6 the state's update.
//
// Bound.  At the path's shape ([4, 500, 64, 64], bf16 r / k / v, f32 w_log
// and states) the call must move ~107 MB (32 us at 3.35 TB/s); its
// operations (TF32 products at 495 TFLOP/s, f32 work at 67 TFLOP/s and the
// exponentials at 16 per SM and clock) take less, so bytes bound it
// (chip_smoke.py prints every term).  The design's answers: one block per
// (row, head, column group) walks the chunks in order, so every input is read
// once and the state never leaves the SM; r / k / v are staged in their own
// dtype by cp.async a phase ahead of their use (w a chunk ahead, double
// buffered), so the loads overlap the compute; the shared memory (115,456 B
// at bf16, D 64) lets two blocks share an SM, so the path's 256 blocks are
// resident at once.  When 2 x B x H blocks fit on the SMs one each, the
// value columns of o and S split across two blocks (column e depends only on
// v's column e; each block recomputes sc): the split changes which block
// computes a column, never the order of its sums, so a row's o and final
// state are bitwise the same alone or inside a batch.  la is summed in step
// order by one thread per channel, as torch.cumsum does on the card: a
// reassociated (parallel) scan changes la's rounding (f32 spacing 6e-5 at
// |la| ~ 700), which the kernel's 1e-4 check against the plain version does
// not allow.
#include "attention_common.cuh"
#include "wkv_mma.cuh"

namespace flame {
namespace k5 {

using namespace wkv;

constexpr int kThreads = 256;
constexpr int kC = 64;               // steps per chunk
constexpr int kL = 16;               // steps per sub-chunk
constexpr int kSub = kC / kL;        // sub-chunks per chunk
constexpr int kBlocks = kSub * (kSub + 1) / 2;  // score blocks on or below
                                                // the diagonal
// per-channel scalars of a chunk, rows of D floats
constexpr int kB = 0;                // B_j, kSub rows
constexpr int kEA = kB + kSub;       // e^{A_i}, kSub rows (row 0 = 1)
constexpr int kG = kEA + kSub;       // e^{la_c - B_j}, kSub rows (last = 1)
constexpr int kX = kG + kSub;        // e^{A_i - B_j} for i - 1 > j: (2,0),
                                     // (3,0), (3,1)
constexpr int kDec = kX + 3;         // e^{la_c}
constexpr int kU = kDec + 1;         // u
constexpr int kScal = kU + 1;
static_assert(kSub == 4, "the cross-factor rows assume four sub-chunks");

// Shared-memory layout (byte offsets) for input type T, head size D and E
// value columns per block.  Rows are padded so that the mma fragment reads
// (8 rows x 4 columns, or 4 rows x 8 columns, a warp) hit distinct banks and
// every row starts on 16 bytes (cp.async).
template <typename T, int D, int E>
struct Smem {
  static constexpr int PT = D + 16 / (int)sizeof(T);  // r, k rows
  static constexpr int PV = E + 8;                    // v rows
  static constexpr int PF = D + 4;  // f32 rows: w -> la_prev -> Q, la -> K
  static constexpr int PS = E + 8;  // state rows
  static constexpr int PB = kL + 4; // score block rows
  static constexpr int r = 0;
  static constexpr int k = r + kC * PT * (int)sizeof(T);
  static constexpr int v = k + kC * PT * (int)sizeof(T);
  static constexpr int w0 = v + kC * PV * (int)sizeof(T);
  static constexpr int w1 = w0 + kC * PF * 4;
  static constexpr int la = w1 + kC * PF * 4;
  static constexpr int sc = la + kC * PF * 4;
  static constexpr int S = sc + kBlocks * kL * PB * 4;
  static constexpr int scal = S + D * PS * 4;
  static constexpr int total = scal + kScal * D * 4;
  static_assert(k % 16 == 0 && v % 16 == 0 && w0 % 16 == 0, "alignment");
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}

// Rows c0 .. c0 + kC - 1 of a [steps, cols] slice (row stride `stride`
// elements, columns contiguous) into shared rows of `pitch` elements; rows
// at or past `len` are zero-filled (the ragged tail: w_log 0 is no decay,
// r = k = v = 0 adds nothing).
template <typename U, int COLS>
__device__ __forceinline__ void stage(U* dst, int pitch, const U* src,
                                      long long stride, int c0, int len,
                                      int tid) {
  constexpr int per = 16 / (int)sizeof(U);
  constexpr int n16 = COLS / per;
  for (int i = tid; i < kC * n16; i += kThreads) {
    const int t = i / n16;
    const int q = i - t * n16;
    const bool ok = c0 + t < len;
    const U* s = ok ? src + (long long)(c0 + t) * stride + q * per : src;
    cp_async16_zfill(dst + t * pitch + q * per, s, ok ? 16 : 0);
  }
}

// Two consecutive outputs, one store (the column is even, so aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One lane's share of a 4 x 4 tile of pairwise scores: rows t = tl .. tl +
// 3 against s = sl .. sl + 3 over channels d0 .. d0 + CH - 1,
//   acc[a][z] = sum_d r[t,d] k[s,d] e^{la_prev[t,d] - la[s,d]}
// (a tile on the diagonal, DIAG: only z < a, and bon[a] = sum_d r u k of
// row a).  r / k rows are PT elements apart, la_prev / la rows PF floats.
template <typename T, int PT, int PF, int CH, bool DIAG>
__device__ __forceinline__ void diag_tile(float (&acc)[4][4], float* bon,
                                          const T* r_s, const T* k_s,
                                          const float* lap, const float* la,
                                          const float* u, int tl, int sl,
                                          int d0) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    bon[a] = 0.f;
#pragma unroll
    for (int z = 0; z < 4; ++z) acc[a][z] = 0.f;
  }
#pragma unroll
  for (int c0 = 0; c0 < CH; c0 += 4) {
    const int d = d0 + c0;
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

template <typename T, int D, int E>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ wl,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ o,
                      float* __restrict__ sf, int S_len, int H, Strides rs,
                      Strides ks, Strides vs, Strides ws, Strides os) {
  using L = Smem<T, D, E>;
  constexpr int NS = D / E;
  constexpr int PT = L::PT, PV = L::PV, PF = L::PF, PS = L::PS, PB = L::PB;
  static_assert(D % 16 == 0 && E % 32 == 0 && D * E >= 1024, "tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_s = reinterpret_cast<T*>(smem + L::r);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  float* wbuf[2] = {reinterpret_cast<float*>(smem + L::w0),
                    reinterpret_cast<float*>(smem + L::w1)};
  float* la_s = reinterpret_cast<float*>(smem + L::la);  // la, then K
  float* sc_s = reinterpret_cast<float*>(smem + L::sc);
  float* S_s = reinterpret_cast<float*>(smem + L::S);
  float* scal = reinterpret_cast<float*>(smem + L::scal);

  const int bh = blockIdx.x / NS;
  const int e0 = (blockIdx.x - bh * NS) * E;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  const T* rb = r + b * rs.n + h * rs.h;
  const T* kb = k + b * ks.n + h * ks.h;
  const T* vb = v + b * vs.n + h * vs.h + e0;
  const float* wb = wl + b * ws.n + h * ws.h;
  T* ob = o + b * os.n + h * os.h + e0;

  for (int i = tid; i < D * E; i += kThreads) {
    const int d = i / E, e = i - d * E;
    S_s[d * PS + e] =
        s0 != nullptr ? s0[(long long)bh * D * D + d * D + e0 + e] : 0.f;
  }
  for (int i = tid; i < D; i += kThreads) scal[kU * D + i] = u[h * D + i];
  // the 4 x 4 tiles above each diagonal block's diagonal are zero for the
  // whole sequence (P2 writes only those on or below it)
  for (int x = tid; x < kSub * kL * kL; x += kThreads) {
    const int i = x / (kL * kL), tt = (x / kL) % kL, ss = x % kL;
    if (ss / 4 > tt / 4) sc_s[blk(i, i) * kL * PB + tt * PB + ss] = 0.f;
  }

  stage<float, D>(wbuf[0], PF, wb, ws.s, 0, S_len, tid);
  stage<T, D>(r_s, PT, rb, rs.s, 0, S_len, tid);
  stage<T, D>(k_s, PT, kb, ks.s, 0, S_len, tid);
  mma::cp_async_commit();
  stage<T, E>(v_s, PV, vb, vs.s, 0, S_len, tid);
  mma::cp_async_commit();

  const int n_chunks = (S_len + kC - 1) / kC;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC;
    const bool last = c == n_chunks - 1;
    float* wq = wbuf[c & 1];  // w, then la_prev, then Q
    // Copy groups, oldest first: w(c + 1), r / k(c + 1), v(c + 1) are
    // committed in that order during chunk c (empty after the last chunk),
    // so that each wait leaves the younger ones in flight.
    mma::cp_async_wait<1>();  // w and r / k of this chunk; v may fly on
    __syncthreads();  // ... have landed; wbuf[(c + 1) & 1] (the previous
                      // chunk's Q) is free
    if (!last)
      stage<float, D>(wbuf[(c + 1) & 1], PF, wb, ws.s, t0 + kC, S_len, tid);
    mma::cp_async_commit();

    // P1: la (inclusive, in step order) and la_prev = la - w in place of w,
    // one thread per channel; then the channel's scalars
    if (tid < D) {
      const int d = tid;
      float w[kC], acc = 0.f, B[kSub];
#pragma unroll
      for (int t = 0; t < kC; ++t) w[t] = wq[t * PF + d];  // loads first:
#pragma unroll                                           // the stores below
      for (int t = 0; t < kC; ++t) {                      // may alias them
        acc += w[t];
        la_s[t * PF + d] = acc;
        wq[t * PF + d] = acc - w[t];
        if (t % kL == kL - 1) B[t / kL] = acc;
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        scal[(kB + j) * D + d] = B[j];
        scal[(kEA + j) * D + d] = j == 0 ? 1.f : __expf(B[j - 1]);
        scal[(kG + j) * D + d] =
            j == kSub - 1 ? 1.f : __expf(B[kSub - 1] - B[j]);
      }
      scal[(kX + 0) * D + d] = __expf(B[1] - B[0]);  // (i, j) = (2, 0)
      scal[(kX + 1) * D + d] = __expf(B[2] - B[0]);  // (3, 0)
      scal[(kX + 2) * D + d] = __expf(B[2] - B[1]);  // (3, 1)
      scal[kDec * D + d] = __expf(B[kSub - 1]);
    }
    __syncthreads();

    // P2: the diagonal blocks of sc, pairwise, in 4 x 4 (t, s) register
    // tiles on or below each block's diagonal: the 16 on the diagonal (6
    // pairs and the bonus r[t].(u*k[t]) each; 16 channels a lane) in the
    // first warps, the 24 below it (16 pairs; 8 channels a lane) in the
    // others, so that a warp takes one kind; a tile's lanes are adjacent and
    // sum their channels by shuffles; zeros above the diagonal (prologue)
    constexpr int kPd = D / 16, kPo = D / 8;
    constexpr int kDiag = 16 * kPd, kOff = 24 * kPo;  // items (lanes)
    static_assert(kDiag % 32 == 0 && kOff % 32 == 0, "whole warps");
    if (tid < kDiag) {
      const int part = tid % kPd, tile = tid / kPd;
      const int i = tile / 4, tl = i * kL + (tile % 4) * 4;
      float acc[4][4], bon[4];
      diag_tile<T, PT, PF, 16, true>(acc, bon, r_s, k_s, wq, la_s,
                                     scal + kU * D, tl, tl, part * 16);
      reduce_tile<kPd>(acc, bon);
      if (part == 0) {
        float* blkp =
            sc_s + blk(i, i) * kL * PB + (tile % 4) * 4 * (PB + 1);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int z = 0; z < 4; ++z)
            blkp[a * PB + z] = z < a ? acc[a][z] : (z == a ? bon[a] : 0.f);
      }
    } else if (tid < kDiag + kOff) {
      const int item = tid - kDiag;
      const int part = item % kPo, tile = item / kPo;
      const int i = tile / 6, p = tile % 6;  // (1,0) (2,0) (2,1) (3,0) ...
      const int tb = p < 1 ? 1 : (p < 3 ? 2 : 3);
      const int sb = p - (tb * (tb - 1)) / 2;
      float acc[4][4], bon[4];
      diag_tile<T, PT, PF, 8, false>(acc, bon, r_s, k_s, wq, la_s,
                                     nullptr, i * kL + tb * 4,
                                     i * kL + sb * 4, part * 8);
      reduce_tile<kPo>(acc, bon);
      if (part == 0) {
        float* blkp = sc_s + blk(i, i) * kL * PB + tb * 4 * PB + sb * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int z = 0; z < 4; ++z) blkp[a * PB + z] = acc[a][z];
      }
    }
    __syncthreads();

    // P3: the factors, in place: Q over la_prev, K over la; four channels
    // of one step a thread
    for (int x = tid; x < kC * D / 4; x += kThreads) {
      const int t = x / (D / 4), d = (x - t * (D / 4)) * 4;
      const int i = t / kL;
      float rv[4], kv[4];
      load4(r_s + t * PT + d, rv);
      load4(k_s + t * PT + d, kv);
      float4* qp = reinterpret_cast<float4*>(wq + t * PF + d);
      float4* kp = reinterpret_cast<float4*>(la_s + t * PF + d);
      const float4 lp = *qp, l = *kp;
      const float4 Bj = *reinterpret_cast<const float4*>(
          scal + (kB + i) * D + d);
      const float4 A = i == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : *reinterpret_cast<const float4*>(
                                    scal + (kB + i - 1) * D + d);
      *qp = make_float4(
          rv[0] * __expf(lp.x - A.x), rv[1] * __expf(lp.y - A.y),
          rv[2] * __expf(lp.z - A.z), rv[3] * __expf(lp.w - A.w));
      *kp = make_float4(
          kv[0] * __expf(Bj.x - l.x), kv[1] * __expf(Bj.y - l.y),
          kv[2] * __expf(Bj.z - l.z), kv[3] * __expf(Bj.w - l.w));
    }
    __syncthreads();
    if (!last) {  // r and k are read: prefetch the next chunk's
      stage<T, D>(r_s, PT, rb, rs.s, t0 + kC, S_len, tid);
      stage<T, D>(k_s, PT, kb, ks.s, t0 + kC, S_len, tid);
    }
    mma::cp_async_commit();

    // P4: the off-diagonal blocks of sc = (Q e^{A_i - B_j}) K^T, one 16 x 16
    // block a warp (its A fragments shared by both 8-column halves)
    if (warp < 6) {
      // blocks in order (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
      const int i = warp < 1 ? 1 : (warp < 3 ? 2 : 3);
      const int j = warp - (i * (i - 1)) / 2;
      const float* xs = i - 1 == j ? nullptr
                        : scal + (kX + (i == 2 ? 0 : j + 1)) * D;
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        FragA a;
        a.load([&](int m, int kk) {
          const float qv = wq[(i * kL + m) * PF + k0 + kk];
          return xs ? qv * xs[k0 + kk] : qv;
        }, g, q);
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          FragB bb;
          bb.load([&](int kk, int n) {
            return la_s[(j * kL + nh * 8 + n) * PF + k0 + kk];
          }, g, q);
          mma3(acc[nh], a, bb);
        }
      }
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float* blkp = sc_s + blk(i, j) * kL * PB + nh * 8 + 2 * q;
        blkp[g * PB] = acc[nh][0];
        blkp[g * PB + 1] = acc[nh][1];
        blkp[(g + 8) * PB] = acc[nh][2];
        blkp[(g + 8) * PB + 1] = acc[nh][3];
      }
    }
    mma::cp_async_wait<2>();  // this chunk's v (the next w, r / k may fly)
    __syncthreads();

    // P5: o = (Q e^{A_i}) S + sc v.  A warp takes the rows of two
    // sub-chunks, i and 3 - i, so that every warp multiplies the same number
    // of score blocks by v, and NTO 8-column tiles.  Then the state's update
    // k_dec^T v into registers.
    constexpr int MT = 2;         // sub-chunks a warp
    constexpr int NTO = E / 32;   // 8-column tiles a warp
    constexpr int GO = 4;         // column groups
    constexpr int NTS = D * E / 1024;
    constexpr int GS = (E / 8) / NTS;  // state column groups per row tile
    float accs[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int z = 0; z < 4; ++z) accs[n][z] = 0.f;
    {  // o
      const int mi[MT] = {warp / GO, kSub - 1 - warp / GO};
      const int n0 = (warp % GO) * NTO * 8;
      float acc[MT][NTO][4];
#pragma unroll
      for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int n = 0; n < NTO; ++n)
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[mm][n][z] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        FragB bb[NTO];
#pragma unroll
        for (int n = 0; n < NTO; ++n)
          bb[n].load([&](int kk, int nn) {
            return S_s[(k0 + kk) * PS + n0 + n * 8 + nn];
          }, g, q);
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          const float* eA = scal + (kEA + mi[mm]) * D + k0;
          const float* qr = wq + mi[mm] * kL * PF + k0;
          FragA a;
          a.load([&](int m, int kk) { return qr[m * PF + kk] * eA[kk]; }, g,
                 q);
#pragma unroll
          for (int n = 0; n < NTO; ++n) mma3(acc[mm][n], a, bb[n]);
        }
      }
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) {
        const int i = mi[mm];
        for (int j = 0; j <= i; ++j) {
          const float* blkp = sc_s + blk(i, j) * kL * PB;
#pragma unroll
          for (int k1 = 0; k1 < kL; k1 += 8) {
            FragA a;
            a.load([&](int m, int kk) { return blkp[m * PB + k1 + kk]; }, g,
                   q);
#pragma unroll
            for (int n = 0; n < NTO; ++n) {
              VFrag<T> vf;
              vf.load(v_s, PV, j * kL + k1, n0 + n * 8, g, q);
              vf.mma(acc[mm][n], a);
            }
          }
        }
        const int row = t0 + i * kL + g;
#pragma unroll
        for (int n = 0; n < NTO; ++n) {
          const int col = n0 + n * 8 + 2 * q;
          if (row < S_len)
            store2(ob + (long long)row * os.s + col, acc[mm][n][0],
                   acc[mm][n][1]);
          if (row + 8 < S_len)
            store2(ob + (long long)(row + 8) * os.s + col, acc[mm][n][2],
                   acc[mm][n][3]);
        }
      }
    }
    {  // k_dec^T v
      const int m0 = (warp / GS) * 16;
      const int n0 = (warp % GS) * NTS * 8;
#pragma unroll 2
      for (int k0 = 0; k0 < kC; k0 += 8) {
        const float* gk = scal + (kG + k0 / kL) * D + m0;
        FragA a;  // k_dec^T: a(d, s) = K[s][d] e^{la_c - B_j}
        a.load([&](int m, int kk) {
          return la_s[(k0 + kk) * PF + m0 + m] * gk[m];
        }, g, q);
#pragma unroll
        for (int n = 0; n < NTS; ++n) {
          VFrag<T> vf;
          vf.load(v_s, PV, k0, n0 + n * 8, g, q);
          vf.mma(accs[n], a);
        }
      }
    }
    __syncthreads();  // every read of the old state and of v is done
    if (!last) stage<T, E>(v_s, PV, vb, vs.s, t0 + kC, S_len, tid);
    mma::cp_async_commit();

    // P6: S' = diag(e^{la_c}) S + k_dec^T v
    {
      const int m0 = (warp / GS) * 16;
      const int n0 = (warp % GS) * NTS * 8;
      const float* dec = scal + kDec * D;
#pragma unroll
      for (int n = 0; n < NTS; ++n)
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int d = m0 + g + (z >> 1) * 8;
          const int e = n0 + n * 8 + 2 * q + (z & 1);
          float* p = S_s + d * PS + e;
          const float s_new =
              __fadd_rn(__fmul_rn(dec[d], *p), accs[n][z]);
          *p = s_new;
          if (last) sf[(long long)bh * D * D + d * D + e0 + e] = s_new;
        }
    }
  }
}

// Blocks per row and head: at D 64, two (32 value columns each) when they
// still fit on the card's SMs one each, else one.
inline int column_split(int B, int H, int D) {
  const int sms = mma::device_attr<cudaDevAttrMultiProcessorCount>(132);
  return D == 64 && 2LL * B * H <= sms ? 2 : 1;
}

template <typename T, int D, int E>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* wl, const float* u, const float* s0, void* o,
                   float* sf, int B, int S, int H, const long long* st,
                   cudaStream_t stream) {
  const int bytes = Smem<T, D, E>::total;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      os{st[12], st[13], st[14]};
  rwkv6_scan_kernel<T, D, E><<<B * H * (D / E), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), wl, u, s0, static_cast<T*>(o), sf, S, H, rs,
      ks, vs, ws, os);
  return cudaGetLastError();
}

template <typename T, int D, int E>
cudaError_t occupancy(int* blocks) {
  const int bytes = Smem<T, D, E>::total;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rwkv6_scan_kernel<T, D, E>, kThreads, bytes);
}

template <typename T>
cudaError_t dispatch(int D, const void* r, const void* k, const void* v,
                     const float* wl, const float* u, const float* s0,
                     void* o, float* sf, int B, int S, int H,
                     const long long* st, cudaStream_t stream) {
  if (D == 32)
    return launch<T, 32, 32>(r, k, v, wl, u, s0, o, sf, B, S, H, st, stream);
  if (D != 64) return cudaErrorInvalidValue;
  if (column_split(B, H, D) == 2)
    return launch<T, 64, 32>(r, k, v, wl, u, s0, o, sf, B, S, H, st, stream);
  return launch<T, 64, 64>(r, k, v, wl, u, s0, o, sf, B, S, H, st, stream);
}

template <typename T, int D, int E>
cudaError_t fill_plan(int B, int H, int* out) {
  out[0] = B * H * (D / E);
  out[1] = kThreads;
  out[2] = Smem<T, D, E>::total;
  out[3] = D / E;
  return occupancy<T, D, E>(&out[4]);
}

template <typename T>
cudaError_t plan(int B, int H, int D, int* out) {
  if (D == 32) return fill_plan<T, 32, 32>(B, H, out);
  if (D != 64) return cudaErrorInvalidValue;
  if (column_split(B, H, D) == 2) return fill_plan<T, 64, 32>(B, H, out);
  return fill_plan<T, 64, 64>(B, H, out);
}

}  // namespace k5
}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o share it; w_log, u, the
// states are f32).  strides: 15 int64 — (row, step, head) element strides of
// r, k, v, w_log and o, whose last axis is contiguous, each a multiple of 16
// bytes, as are the pointers.  u is [H, D] contiguous; s0 (NULL: zeros) and
// sf are [B, H, D, D] contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const float* w_log, const float* u,
                              const float* s0, void* o, float* sf, int dtype,
                              int B, int S, int H, int D,
                              const long long* strides, void* stream) {
  using namespace flame::k5;
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H * 4 > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, r, k, v, w_log, u, s0, o, sf, B, S, H, strides,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, r, k, v, w_log, u, s0, o, sf, B, S, H,
                                   strides, st);
  return cudaErrorInvalidValue;
}

// Launch plan: out[0..4] = grid, threads per block, shared bytes, column
// split (blocks per row and head), resident blocks per SM.
extern "C" int rwkv6_scan_plan(int dtype, int B, int H, int D, int* out) {
  using namespace flame::k5;
  if (dtype == 0) return plan<float>(B, H, D, out);
  if (dtype == 1) return plan<__nv_bfloat16>(B, H, D, out);
  return cudaErrorInvalidValue;
}
