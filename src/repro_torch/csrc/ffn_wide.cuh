// K3 at model widths past one shared-memory tile (the text models' d 3840:
// gemma3-12b, h2o-danube-3-4b) — included by fused_ffn.cu alone.
//
// The same function as fused_ffn.cu's kernels,
//   out = act(n(x) @ W_up [* silu(n(x) @ W_gate)]) @ W_down,
// for bf16 x [T, d], W_up / W_gate [d, F], W_down [F, d], any d and F that
// are multiples of 8.  The d 64 / 256 kernel holds a whole [64, d] x tile
// and a [64, d] f32 partial in shared memory: 491 KB and 983 KB at d 3840,
// so this kernel tiles d on both products instead.
//
// Design (mma.sync m16n8k16, bf16 in, f32 accumulate; 8 warps):
// - d_ff is cut into slices of FS columns (a multiple of 128, chosen by the
//   wrapper from T: at T <= 16 slices of 128, so that a layer's weights
//   stream over ~100 CTAs; past that as wide as two waves of CTAs allow, at
//   most 512: the hidden [64, 512] as bf16 hi + lo fills shared memory;
//   the wrapper launches at most 2048 rows at a time, which bounds the
//   workspace).  A CTA owns one m tile of BM rows (16 or 64) and one
//   slice; blockIdx.x walks the m tiles, so the CTAs that share a slice's
//   weights run together and read them from L2;
// - phase 1, the up (and gate) product: the slice's hidden [BM, FS] in
//   passes of 128 columns, each a k-loop over d in 64-column tiles of x and
//   W_up (and W_gate), staged by cp.async two tiles deep (zero-filled past
//   T, d and F).  With has_norm, each row's 1 / rms is computed first and
//   the A fragments are built as n(x) in f32, entered as bf16 hi + lo.
//   The activation runs in f32 and the hidden goes to shared memory as bf16
//   hi + lo (~16 bits), never to device memory;
// - phase 2, the down product: for each 128-column tile of the output, the
//   hidden [BM, FS] (hi, then lo, per k step) times W_down's [FS, 128]
//   rows, staged 64 at a time, written as the slice's f32 partial to a
//   workspace [slices, T, d] that the wrapper allocates;
// - a second kernel sums the partials in slice order 0 .. S-1 and rounds
//   once to bf16.  No atomics: a given shape is bitwise reproducible.  The
//   slices follow T, so a row's output is not bitwise the same across T
//   (the text engine's gate is greedy == repeated prefill, which this
//   keeps within the bf16 contract); the Climber path keeps its kernel.
// What bounds it: at T = 4 the bytes of the weights (236 MB a gemma3
// layer, 0.070 ms at 3.35 TB/s); at T = 2000 the products (0.48 ms of
// bf16 FLOPs); the partials add slices x T x d x 8 bytes of traffic (1.8
// GB at gemma3's 30 slices, T = 2000), which is not what holds it back:
// summing a thread-block cluster's slices on chip through distributed
// shared memory cut it to 0.3 GB and made the kernel slower on an H100 at
// every cluster size tried, 2 to 6 (PERF.md): with one CTA an SM, every
// cluster barrier idles the tensor cores.
#pragma once

namespace flame {
namespace ffn {
namespace wide {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;   // d columns (phase 1) or d_ff rows (phase 2) a stage
constexpr int kCP = 128;  // hidden columns a phase-1 pass
constexpr int kBN = 128;  // output columns a phase-2 tile
constexpr int kXP = kKC + 8;   // pitches (elements): 16 bytes past a multiple
constexpr int kWP = kCP + 8;   // of 128, so ldmatrix rows hit distinct banks

template <int BM, bool GATED>
struct Cfg {
  static constexpr int WM = BM / 16;          // warps along the rows
  static constexpr int WN = kWarps / WM;      // warps along the columns
  static constexpr int NT1 = kCP / WN / 8;    // n tiles a warp, phase 1
  static constexpr int NT2 = kBN / WN / 8;    // n tiles a warp, phase 2
  static constexpr int STAGE1 = BM * kXP + (GATED ? 2 : 1) * kKC * kWP;
  static constexpr int STAGE2 = kKC * kWP;
  static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;  // elems
};

// Dynamic shared bytes: two ring slots, the hidden hi and lo [BM, FS + 8],
// the rows' 1 / rms.
template <int BM, bool GATED>
__host__ __device__ inline int smem_bytes(int fs) {
  return (2 * Cfg<BM, GATED>::STAGE + 2 * BM * (fs + 8)) * 2 + BM * 4;
}

template <int BM, bool GATED, bool NORM>
__global__ void __launch_bounds__(kThreads, 1)
    wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                const bf16* __restrict__ w_up, const bf16* __restrict__ w_gate,
                const bf16* __restrict__ w_down, float* __restrict__ ws,
                int T_, int d, int F, int fs, int act) {
  using C = Cfg<BM, GATED>;
  constexpr int NT1 = C::NT1, NT2 = C::NT2;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* ring = reinterpret_cast<bf16*>(wide_smem);
  const int hp = fs + 8;  // hidden pitch
  bf16* hh = ring + 2 * C::STAGE;
  bf16* hl = hh + BM * hp;
  float* inv = reinterpret_cast<float*>(hl + BM * hp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = blockIdx.x * BM;
  const int f_lo = blockIdx.y * fs;  // this slice's first d_ff column
  const int kch = (d + kKC - 1) / kKC;
  const int passes = fs / kCP;
  const int fch = fs / kKC;
  const int nto = (d + kBN - 1) / kBN;

  if constexpr (NORM) {
    for (int r = warp; r < BM; r += kWarps) {
      float ss = 0.f;
      if (r0 + r < T_) {
        const bf16* xr = x + (long long)(r0 + r) * d;
        for (int c = lane; c < d; c += 32) {
          const float v = __bfloat162float(xr[c]);
          ss += v * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv[r] = rsqrtf(ss / d + kEps);
    }
    __syncthreads();
  }

  // the two phases' stage streams, each through the same two-slot ring
  auto stream = [&](int n, auto issue, auto consume) {
    issue(0, ring);
    mma::cp_async_commit();
    for (int i = 0; i < n; ++i) {
      if (i + 1 < n) issue(i + 1, ring + ((i + 1) & 1) * C::STAGE);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      __syncthreads();
      consume(i, ring + (i & 1) * C::STAGE);
      __syncthreads();  // every warp is done with slot i & 1
    }
    mma::cp_async_wait<0>();
  };

  // ---- phase 1: hidden [BM, fs] = act(n(x) W_up [, n(x) W_gate]) ----
  auto issue1 = [&](int i, bf16* st) {
    const int p = i / kch, k0 = (i - p * kch) * kKC;
    const int f0 = f_lo + p * kCP;
    bf16* xs = st;
    bf16* us = xs + BM * kXP;
    for (int e = tid; e < BM * (kKC / 8); e += kThreads) {
      const int r = e >> 3, c = (e & 7) * 8;
      const bool ok = r0 + r < T_ && k0 + c < d;
      mma::cp_async16_zfill(xs + r * kXP + c,
                            ok ? x + (long long)(r0 + r) * d + k0 + c : x, ok);
    }
#pragma unroll
    for (int m = 0; m < (GATED ? 2 : 1); ++m) {
      const bf16* w = m ? w_gate : w_up;
      bf16* ws_ = us + m * kKC * kWP;
      for (int e = tid; e < kKC * (kCP / 8); e += kThreads) {
        const int r = e / (kCP / 8), c = (e - r * (kCP / 8)) * 8;
        const bool ok = k0 + r < d && f0 + c < F;
        mma::cp_async16_zfill(ws_ + r * kWP + c,
                              ok ? w + (long long)(k0 + r) * F + f0 + c : w,
                              ok);
      }
    }
  };
  float cu[NT1][4], cg[GATED ? NT1 : 1][4];
  auto consume1 = [&](int i, const bf16* st) {
    const int p = i / kch, kc = i - p * kch, k0 = kc * kKC;
    const bf16* xs = st;
    const bf16* us = xs + BM * kXP;
    const bf16* gs = us + kKC * kWP;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cu[j][e] = 0.f;
          if constexpr (GATED) cg[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      unsigned ah[4], al[4];
      if constexpr (NORM) {
        // n(x) = x / rms (1 + scale) in f32, as bf16 hi + lo
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wm * 16 + g + 8 * (q & 1);
          const int c = kk * 16 + 2 * t + 8 * (q >> 1);
          const unsigned w2 = mma::ld32(xs + r * kXP + c);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + c + e;
            const float sc =
                col < d ? 1.f + __bfloat162float(scale[col]) : 0.f;
            v[e] = __uint_as_float(e ? (w2 & 0xffff0000u) : (w2 << 16)) *
                   inv[r] * sc;
          }
          mma::split2(v[0], v[1], ah[q], al[q]);
        }
      } else {
        mma::load_a_x4(ah, xs, kXP, wm * 16, kk * 16, lane);
      }
#pragma unroll
      for (int jp = 0; jp < NT1 / 2; ++jp) {
        const int n0 = wn * (kCP / C::WN) + jp * 16;
        unsigned b[4];
        mma::load_b_trans_x4(b, us, kWP, kk * 16, n0, lane);
        mma::mma_bf16(cu[2 * jp], ah, b);
        mma::mma_bf16(cu[2 * jp + 1], ah, b + 2);
        if constexpr (NORM) {
          mma::mma_bf16(cu[2 * jp], al, b);
          mma::mma_bf16(cu[2 * jp + 1], al, b + 2);
        }
        if constexpr (GATED) {
          mma::load_b_trans_x4(b, gs, kWP, kk * 16, n0, lane);
          mma::mma_bf16(cg[2 * jp], ah, b);
          mma::mma_bf16(cg[2 * jp + 1], ah, b + 2);
          if constexpr (NORM) {
            mma::mma_bf16(cg[2 * jp], al, b);
            mma::mma_bf16(cg[2 * jp + 1], al, b + 2);
          }
        }
      }
    }
    if (kc == kch - 1) {  // activation; the hidden as bf16 hi + lo
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float h[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float up = cu[j][2 * half + q];
            if constexpr (GATED)
              h[q] = silu_fast(cg[j][2 * half + q]) * up;
            else
              h[q] = act == kGelu ? gelu_fast(up) : fmaxf(up, 0.f);
          }
          unsigned hi, lo;
          mma::split2(h[0], h[1], hi, lo);
          const int r = wm * 16 + g + 8 * half;
          const int c = p * kCP + wn * (kCP / C::WN) + j * 8 + 2 * t;
          *reinterpret_cast<unsigned*>(hh + r * hp + c) = hi;
          *reinterpret_cast<unsigned*>(hl + r * hp + c) = lo;
        }
      }
    }
  };
  stream(passes * kch, issue1, consume1);

  // ---- phase 2: the slice's partial [BM, d] = hidden @ W_down[slice] ----
  auto issue2 = [&](int i, bf16* st) {
    const int nt = i / fch, f0 = f_lo + (i - nt * fch) * kKC;
    const int n0 = nt * kBN;
    for (int e = tid; e < kKC * (kBN / 8); e += kThreads) {
      const int r = e / (kBN / 8), c = (e - r * (kBN / 8)) * 8;
      const bool ok = f0 + r < F && n0 + c < d;
      mma::cp_async16_zfill(
          st + r * kWP + c,
          ok ? w_down + (long long)(f0 + r) * d + n0 + c : w_down, ok);
    }
  };
  float co[NT2][4];
  float* wsl = ws + (long long)blockIdx.y * T_ * d;
  auto consume2 = [&](int i, const bf16* st) {
    const int nt = i / fch, fc = i - nt * fch;
    if (fc == 0) {
#pragma unroll
      for (int j = 0; j < NT2; ++j)
        co[j][0] = co[j][1] = co[j][2] = co[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      unsigned ah[4], al[4];
      mma::load_a_x4(ah, hh, hp, wm * 16, fc * kKC + kk * 16, lane);
      mma::load_a_x4(al, hl, hp, wm * 16, fc * kKC + kk * 16, lane);
#pragma unroll
      for (int jp = 0; jp < NT2 / 2; ++jp) {
        unsigned b[4];
        mma::load_b_trans_x4(b, st, kWP, kk * 16,
                             wn * (kBN / C::WN) + jp * 16, lane);
        mma::mma_bf16(co[2 * jp], ah, b);
        mma::mma_bf16(co[2 * jp + 1], ah, b + 2);
        mma::mma_bf16(co[2 * jp], al, b);
        mma::mma_bf16(co[2 * jp + 1], al, b + 2);
      }
    }
    if (fc == fch - 1) {
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const int c = nt * kBN + wn * (kBN / C::WN) + j * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + wm * 16 + g + 8 * half;
          if (r < T_ && c < d)
            *reinterpret_cast<float2*>(wsl + (long long)r * d + c) =
                make_float2(co[j][2 * half], co[j][2 * half + 1]);
        }
      }
    }
  };
  stream(nto * fch, issue2, consume2);
}

// out = bf16(sum of the slices' partials in slice order), 4 columns a thread
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                  long long n4, int slices) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n4) return;
  const float4* w = reinterpret_cast<const float4*>(ws);
  float4 s = w[i];
  for (int k = 1; k < slices; ++k) {
    const float4 v = w[k * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<uint2*>(out)[i] =
      make_uint2(mma::cvt2(s.x, s.y), mma::cvt2(s.z, s.w));
}

template <int BM, bool GATED, bool NORM>
cudaError_t launch3(const void* x, const void* scale, const void* w_up,
                    const void* w_gate, const void* w_down, void* out,
                    float* ws, int T_, int d, int F, int fs, int act,
                    cudaStream_t stream) {
  const int bytes = smem_bytes<BM, GATED>(fs);
  auto kernel = wide_kernel<BM, GATED, NORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int slices = (F + fs - 1) / fs;
  kernel<<<dim3((T_ + BM - 1) / BM, slices), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_down), ws, T_, d, F, fs, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = (long long)T_ * d / 4;
  reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      ws, static_cast<bf16*>(out), n4, slices);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bm(const void* x, const void* scale, const void* w_up,
                      const void* w_gate, const void* w_down, void* out,
                      float* ws, int T_, int d, int F, int fs, int act,
                      int has_norm, cudaStream_t s) {
  const bool gated = act == kSwiglu;
  if (gated && has_norm)
    return launch3<BM, true, true>(x, scale, w_up, w_gate, w_down, out, ws,
                                   T_, d, F, fs, act, s);
  if (gated)
    return launch3<BM, true, false>(x, scale, w_up, w_gate, w_down, out, ws,
                                    T_, d, F, fs, act, s);
  if (has_norm)
    return launch3<BM, false, true>(x, scale, w_up, w_gate, w_down, out, ws,
                                    T_, d, F, fs, act, s);
  return launch3<BM, false, false>(x, scale, w_up, w_gate, w_down, out, ws,
                                   T_, d, F, fs, act, s);
}

}  // namespace wide
}  // namespace ffn
}  // namespace flame
