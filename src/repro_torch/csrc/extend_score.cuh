// K1's extend mode on the tensor cores: bf16 q over an int8 or bf16 prefix
// (fused_score.cu; the `extend` family of the DSO, once per layer).
//
// The function (cached_score.cuh, mode "extend"), per (batch row b, head h,
// suffix row r < M): one softmax over
//   the prefix: keys [0, len) of pool row `row` (row_index[b], or b) in its
//               stored type, the per-(row, kv head) scale folded in, len =
//               lengths[row] (S without lengths);
//   the suffix: keys j <= r of k_cand[b] / v_cand[b] (causal), bf16.
//
// Bound: at the path's shapes — q [4, 1, 4, 64] over 256 bf16 prefix rows
// (a tail append) and [4, 129, 4, 64] over 128 (an edit) — the function
// moves ~1.1-1.6 MB, 0.3-0.5 us at 3.35 TB/s on an H100, and does at most
// ~0.1 GFLOP (0.1 us at 989 TFLOP/s).  The time is latency: the launch,
// the first tile's load and each warp's chain of dependent tiles (16
// blocks at M = 1, 144 at M = 129; at most 3 tiles a warp at both).  The
// scalar kernel (fused_score_kernel: one thread per query row) left one
// live thread of 32 folding 257 keys at M = 1.
//
// Design, cs::extend_mma_kernel (the cached kernel's pieces, one pool row):
// - A block of kWarps warps owns 16 suffix rows [w0, w0 + 16) of one
//   (batch row, head); Q stays in registers as bf16 A fragments, rows past
//   M zero; S = Q K^T and O += P V run on mma.sync.m16n8k16.
// - The block's keys are the prefix tiles (BK keys each, from 0) followed
//   by the suffix tiles over keys [0, min(w0 + 16, M)) (BK each, from 0):
//   global tile i goes to warp i % kWarps, which streams its tiles through
//   its own two-slot ring (bf16 through cp.async where rows sit on 16-byte
//   boundaries, int8 fetched into registers one tile ahead and converted
//   exactly to bf16 as it is stored, any other stride element by element).
//   The warps' (m, l, acc) are combined in warp order at the end.
// - Scales stay in f32: the prefix scores are multiplied by k scale x
//   scale (x log2 e) after Q K^T, and each warp's accumulator by the v
//   scale once its prefix tiles are done, before suffix values enter it.
// - A masked key (past len in the prefix; past M or after the row in the
//   suffix) has its score set to -1e30 before the max and its P *selected*
//   to 0 after it: a warp that has seen no key of a row yet holds m =
//   -1e30, and the exp of the sentinel would give it a weight of 1.  P
//   enters P V as bf16 hi + lo.
// - Bitwise: which tiles exist, and which warp folds each, follows len and
//   the key index alone (no split grows with the grid); a tile whose keys
//   all lie after a row leaves that row's state unchanged (factor ex2(0) =
//   1, P and its products exact zeros); the combine runs in warp order.  So
//   a row's output depends on its q row, its pool row and len, and the
//   suffix rows up to it — not on M, the block's other rows, how far the
//   prefix is padded, or the call; lengths == S is the call without
//   lengths; no atomics.
#pragma once

#include "cached_score.cuh"

namespace flame {
namespace cs {

// Rows [0, n) of an operand (row stride `stride` elements, rows of D) into
// a BK x LD bf16 slot, rows past n zero: element by element, any alignment.
template <typename T, int D, int BK, int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const T* src,
                                          long long stride, int n, int lane) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = lane; e < BK * D; e += 32) {
    const int r = e / D, c = e - r * D;
    dst[r * LD + c] = r < n ? to_bf16(src[r * stride + c]) : zero;
  }
}

// The same for bf16 rows on 16-byte boundaries, through cp.async.
template <int D, int BK, int LD>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* src,
                                           long long stride, int n,
                                           int lane) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = lane; e < BK * CPR; e += 32) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    bf16* d = dst + r * LD + c;
    if (r < n)
      mma::cp_async16(d, src + r * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

template <typename TH, int D>
__global__ void __launch_bounds__(kWarps * 32) extend_mma_kernel(
    const bf16* __restrict__ q, const TH* __restrict__ k_hist,
    const TH* __restrict__ v_hist, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const bf16* __restrict__ k_cand,
    const bf16* __restrict__ v_cand, const int* __restrict__ row_index,
    const int* __restrict__ lengths, bf16* __restrict__ o, int H, int Hkv,
    int M, int U, int S, Strides qs, Strides khs, Strides vhs, Strides kcs,
    Strides vcs, Strides os, float scale) {
  constexpr bool kInt8 = sizeof(TH) == 1;
  constexpr int BK = Cfg<D>::BK, LD = Cfg<D>::LD;
  constexpr int KD = D / 16, NS = BK / 8, NO = D / 8;
  constexpr int CPR = D / 16;                 // int8: 16-byte chunks per row
  constexpr int CHUNKS = BK * CPR;            // per operand and tile
  constexpr int PER = (CHUNKS + 31) / 32;     // per lane
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int w0 = blockIdx.x * 16;  // the block's first suffix row
  const int rw[2] = {w0 + g, w0 + g + 8};  // the thread's two rows

  unsigned qf[KD][4];
  {
    const bf16* qb = q + b * qs.n + h * qs.h;
    const bool pairs =
        reinterpret_cast<uintptr_t>(qb) % 4 == 0 && qs.s % 2 == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* qr = qb + (long long)rw[half] * qs.s;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int c = kk * 16 + 2 * t + 8 * hi;
          unsigned w = 0u;
          if (rw[half] < M)
            w = pairs ? mma::ld32(qr + c) : mma::pack2(qr[c], qr[c + 1]);
          qf[kk][half + 2 * hi] = w;
        }
      }
    }
  }

  // the prefix: one pool row
  const int row = pool_row(row_index, 0, b, 0, M, U);
  const int len = lengths ? min(max(lengths[row], 0), S) : S;
  const float c_hist =
      scale * (k_scale ? k_scale[row * Hkv + kvh] : 1.f) * kLog2e;
  const float c_suf = scale * kLog2e;
  const float vsc = v_scale ? v_scale[row * Hkv + kvh] : 1.f;
  const TH* kb = k_hist + row * khs.n + kvh * khs.h;
  const TH* vb = v_hist + row * vhs.n + kvh * vhs.h;
  const bool vec_p = ((reinterpret_cast<uintptr_t>(kb) |
                       reinterpret_cast<uintptr_t>(vb)) % 16 == 0) &&
                     (khs.s * (long long)sizeof(TH)) % 16 == 0 &&
                     (vhs.s * (long long)sizeof(TH)) % 16 == 0;
  // the suffix keys the block's rows can see
  const int kend = min(w0 + 16, M);
  const bf16* kcb = k_cand + b * kcs.n + kvh * kcs.h;
  const bf16* vcb = v_cand + b * vcs.n + kvh * vcs.h;
  const bool vec_s = ((reinterpret_cast<uintptr_t>(kcb) |
                       reinterpret_cast<uintptr_t>(vcb)) % 16 == 0) &&
                     kcs.s % 8 == 0 && vcs.s % 8 == 0;

  // the warp's kc-th tile is global tile warp + kWarps kc: prefix tiles
  // first (ntp of them), then the suffix's
  const int ntp = (len + BK - 1) / BK;
  const int nt = ntp + (kend + BK - 1) / BK;
  const int nk = nt > warp ? (nt - warp + kWarps - 1) / kWarps : 0;
  const int nkp = ntp > warp ? (ntp - warp + kWarps - 1) / kWarps : 0;
  auto tile = [&](int kc) { return warp + kc * kWarps; };
  // first key and key count of the warp's tile kc in its segment
  auto first = [&](int kc) {
    return (kc < nkp ? tile(kc) : tile(kc) - ntp) * BK;
  };
  auto count = [&](int kc) {
    return min(BK, (kc < nkp ? len : kend) - first(kc));
  };

  bf16* ring = reinterpret_cast<bf16*>(smem + warp * Cfg<D>::WARP_BYTES);
  auto k_slot = [&](int s) { return ring + s * 2 * BK * LD; };
  auto v_slot = [&](int s) { return ring + s * 2 * BK * LD + BK * LD; };

  uint4 pk[PER], pv[PER];
  auto fetch = [&](int kc) {  // int8 prefix codes into registers
    const int t0 = first(kc), n = count(kc);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + j * 32;
      const int r = e / CPR, c = (e - r * CPR) * 16;
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
        const int r = e / CPR, c = (e - r * CPR) * 16;
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
  // stages the warp's tile kc into slot s as one cp.async group (empty
  // where the tile was written by plain stores)
  auto produce = [&](int kc, int s) {
    const int t0 = first(kc), n = count(kc);
    if (kc < nkp) {
      const TH* kp = kb + (long long)t0 * khs.s;
      const TH* vp = vb + (long long)t0 * vhs.s;
      if (!vec_p) {
        copy_rows<TH, D, BK, LD>(k_slot(s), kp, khs.s, n, lane);
        copy_rows<TH, D, BK, LD>(v_slot(s), vp, vhs.s, n, lane);
      } else if constexpr (kInt8) {
        put(s);
        if (kc + 1 < nkp) fetch(kc + 1);
      } else {
        async_rows<D, BK, LD>(k_slot(s), kp, khs.s, n, lane);
        async_rows<D, BK, LD>(v_slot(s), vp, vhs.s, n, lane);
      }
    } else {
      const bf16* kp = kcb + (long long)t0 * kcs.s;
      const bf16* vp = vcb + (long long)t0 * vcs.s;
      if (vec_s) {
        async_rows<D, BK, LD>(k_slot(s), kp, kcs.s, n, lane);
        async_rows<D, BK, LD>(v_slot(s), vp, vcs.s, n, lane);
      } else {
        copy_rows<bf16, D, BK, LD>(k_slot(s), kp, kcs.s, n, lane);
        copy_rows<bf16, D, BK, LD>(v_slot(s), vp, vcs.s, n, lane);
      }
    }
    mma::cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  auto scale_acc = [&] {  // the prefix's v scale, before suffix values
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= vsc;
  };

  auto compute = [&](int kc, int s) {
    const bool suf = kc >= nkp;
    const int t0 = first(kc), n = count(kc);
    const float c = suf ? c_suf : c_hist;
    // key `col` of the tile counts for the thread's row `half`
    auto ok = [&](int col, int half) {
      return col < n && (!suf || t0 + col <= rw[half]);
    };
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
      for (int e = 0; e < 4; ++e)
        sc[j][e] = ok(j * 8 + 2 * t + (e & 1), e >> 1) ? sc[j][e] * c
                                                       : kNegInf;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = mma::ex2(m[half] - mx);
      l[half] *= corr;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * half] *= corr;
        acc[j][2 * half + 1] *= corr;
      }
      m[half] = mx;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // selected, not the exp of the sentinel: m may still be -1e30
          p[jj][e] = ok(kk * 16 + jj * 8 + 2 * t + (e & 1), e >> 1)
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

  if (kInt8 && vec_p && nkp > 0) fetch(0);
  if (nk > 0) produce(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {  // slot (kc + 1) & 1 was freed by the last syncwarp
      produce(kc + 1, (kc + 1) & 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncwarp();
    if (kc == nkp) scale_acc();
    compute(kc, kc & 1);
    __syncwarp();
  }
  if (nk == nkp) scale_acc();  // a warp with no suffix tile
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

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rw[half] >= M) continue;
    const float den = fmaxf(l[half], 1e-30f);
    bf16* orow = o + b * os.n + h * os.h + (long long)rw[half] * os.s;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t;
      orow[c] = __float2bfloat16(acc[j][2 * half] / den);
      orow[c + 1] = __float2bfloat16(acc[j][2 * half + 1] / den);
    }
  }
}

}  // namespace cs

template <typename TH, int D>
cudaError_t launch_extend(const ScoreArgs& a, cudaStream_t stream) {
  constexpr int bytes = cs::Cfg<D>::SMEM;
  auto kernel = cs::extend_mma_kernel<TH, D>;
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
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.scale);
  return cudaGetLastError();
}

}  // namespace flame
