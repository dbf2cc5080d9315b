// Chunked RWKV-6 wkv scan for Hopper (sm_90a) — kernel K5 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel (body _wkv_kernel).  It computes the same function: per
// (row b, head h), with w = exp(w_log) per step and channel,
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t S_{t-1} + (r_t.(u*k_t)) v_t
// in chunks of kC steps.  Inside a chunk, with la the inclusive cumulative
// sum of w_log over the chunk's steps and la_prev = la - w_log (exclusive, as
// the reference forms it, not a shifted sum):
//   o[t]   = (r[t] * exp(la_prev[t])) S
//          + sum_{s<t} (sum_d r[t,d] k[s,d] exp(la_prev[t,d] - la[s,d])) v[s]
//          + (r[t] . (u * k[t])) v[t]
//   S'     = diag(exp(la_c)) S + sum_s (k[s] * exp(la_c - la[s])) v[s]^T
// where la_c is la at the chunk's last step.  The intra-chunk term stays
// pairwise: every exponent is <= 0.  w_log reaches -20 per step on the
// model's path, so a chunk's decay reaches -1280, where the factored form
// (r e^{la_prev}) . (k e^{-la}) would be 0 x inf.  So each chunk and head
// evaluates kC (kC - 1) / 2 x D exponentials, as the TPU kernel does.
//
// Design.  The TPU grid is (BH, n_chunks) with the [D, D] state in VMEM
// scratch across its sequential chunk axis.  Blocks on Hopper run in no
// order, so one block of kScanThreads threads owns one (row, head) and loops
// over the chunks itself, with the state in shared memory for the whole
// sequence: it never goes back to device memory between chunks, and every
// input element is read once.  Per chunk:
//   A  the chunk's r, k, v (bf16 or f32) and w_log (f32), loaded into
//      registers while the previous chunk computed, are staged in f32
//      shared memory, and the next chunk's loads are issued; steps past the
//      sequence end load as zero (w_log 0: no decay, k = v = 0: no state
//      change), which is the JAX wrapper's padding done as a mask; one
//      thread per channel then forms la and la_prev by a sequential sum;
//   B  scores[t, s] for s < t in 4 x 4 (t, s) register tiles over the lower
//      triangle (136 tiles of 16 pairs: 8 shared loads feed 16 exponentials
//      per channel), with the bonus r[t].(u*k[t]) on the diagonal, so that
//      the output needs one product with v;
//   C  r[t] is replaced by r[t] exp(la_prev[t]) and k[s] by
//      k[s] exp(la_c - la[s]);
//   D  every thread owns a 4 x 4 output tile: o = r_dec S + scores v, written
//      only for steps inside the sequence;
//   E  every thread owns a 4 x 4 tile of S and applies the update.
// Rows are padded to D + 1 floats (read in columns) or D + 4 (read as
// float4: v, S), so shared-memory reads rarely collide.
//
// Bound.  At the path's shapes ([4, 500, 64, 64], bf16 r / k / v, f32
// w_log, f32 states) the kernel must move ~107 MB (32 us at 3.35 TB/s) but
// do ~3.7 GFLOP of f32 work outside the tensor cores (56 us at 67 TFLOP/s)
// and ~0.27 G exponentials; chip_smoke.py computes the bound from its
// inputs.  So it is bound by operations.  This version spends them as
// scalar f32 FMAs and __expf with one block of 118.5 KB shared memory per
// SM (8 warps): it runs ~9x its bound (PERF.md).  Later levers: the three
// [64 x 64] products of a chunk on tensor cores, more warps per SM, and at
// B = 1 (H = 64 blocks on 132 SMs) the state's value columns split across
// blocks (column e of S depends only on column e of v).
#include "attention_common.cuh"

namespace flame {

constexpr int kScanThreads = 256;
constexpr int kC = 64;  // steps per chunk

// Shared-memory layout (float offsets) for head size D.
template <int D>
struct ScanSmem {
  static constexpr int P1 = D + 1;  // r, k, la, la_prev rows
  static constexpr int P4 = D + 4;  // v, S rows (float4 reads)
  static constexpr int PC = kC + 1; // scores rows
  static constexpr int r = 0;
  static constexpr int k = r + kC * P1;
  static constexpr int la = k + kC * P1;
  static constexpr int lap = la + kC * P1;
  static constexpr int v = lap + kC * P1;  // 4 kC P1: a multiple of 4
  static constexpr int S = v + kC * P4;
  static constexpr int sc = S + D * P4;
  static constexpr int u = sc + kC * PC;
  static constexpr int lac = u + D;
  static constexpr int total = lac + D;
};

template <typename T, int D>
__global__ void __launch_bounds__(kScanThreads)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ wl,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ o,
                      float* __restrict__ sf, int S_len, int H, Strides rs,
                      Strides ks, Strides vs, Strides ws, Strides os) {
  static_assert(kC % 4 == 0 && (kC * D) % kScanThreads == 0, "tiling");
  using L = ScanSmem<D>;
  constexpr int P1 = L::P1, P4 = L::P4, PC = L::PC;
  constexpr int kTE = D / 4;  // 4-wide column groups
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm + L::r;
  float* k_s = sm + L::k;
  float* la_s = sm + L::la;
  float* lap_s = sm + L::lap;
  float* v_s = sm + L::v;
  float* S_s = sm + L::S;
  float* sc_s = sm + L::sc;
  float* u_s = sm + L::u;
  float* lac_s = sm + L::lac;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;

  for (int i = tid; i < D * D; i += kScanThreads) {
    const int d = i / D;
    S_s[d * P4 + (i - d * D)] = s0 != nullptr ? s0[bh * D * D + i] : 0.f;
  }
  for (int i = tid; i < D; i += kScanThreads) u_s[i] = u[h * D + i];

  const T* rb = r + b * rs.n + h * rs.h;
  const T* kb = k + b * ks.n + h * ks.h;
  const T* vb = v + b * vs.n + h * vs.h;
  const float* wb = wl + b * ws.n + h * ws.h;
  T* ob = o + b * os.n + h * os.h;

  // the chunk's inputs pass through registers: the next chunk's loads are
  // issued before this chunk's compute, so their latency overlaps it
  constexpr int kIt = kC * D / kScanThreads;
  float rr[kIt], kr[kIt], vr[kIt], wr[kIt];
  auto fetch = [&](int c0) {
    const int nn = min(kC, S_len - c0);
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kScanThreads;
      const int t = i / D;
      const int d = i - t * D;
      rr[it] = kr[it] = vr[it] = wr[it] = 0.f;
      if (t < nn) {
        const long long tt = c0 + t;
        rr[it] = to_f32(rb[tt * rs.s + d]);
        kr[it] = to_f32(kb[tt * ks.s + d]);
        vr[it] = to_f32(vb[tt * vs.s + d]);
        wr[it] = wb[tt * ws.s + d];
      }
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < S_len; t0 += kC) {
    const int n = min(kC, S_len - t0);
    const bool last = t0 + kC >= S_len;
    __syncthreads();  // the previous chunk's readers are done
    // A: stage the chunk (zeros past the sequence end); la_prev holds w_log
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kScanThreads;
      const int t = i / D;
      const int d = i - t * D;
      r_s[t * P1 + d] = rr[it];
      k_s[t * P1 + d] = kr[it];
      v_s[t * P4 + d] = vr[it];
      lap_s[t * P1 + d] = wr[it];
    }
    if (!last) fetch(t0 + kC);
    __syncthreads();
    for (int d = tid; d < D; d += kScanThreads) {
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < kC; ++t) {
        const float w = lap_s[t * P1 + d];
        acc += w;
        la_s[t * P1 + d] = acc;
        lap_s[t * P1 + d] = acc - w;
      }
      lac_s[d] = acc;
    }
    __syncthreads();
    // B: scores[t, s] for s < t in 4 x 4 (t, s) register tiles over the
    // lower triangle; diagonal tiles put the bonus r[t].(u*k[t]) at s == t
    // and zeros above it
    constexpr int kTB = kC / 4;
    for (int tile = tid; tile < kTB * (kTB + 1) / 2; tile += kScanThreads) {
      int tb = static_cast<int>((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
      while ((tb + 1) * (tb + 2) / 2 <= tile) ++tb;
      while (tb * (tb + 1) / 2 > tile) --tb;
      const int sb = tile - tb * (tb + 1) / 2;
      const int tl = tb * 4, sl = sb * 4;
      if (tl >= n) continue;
      const bool diag = sb == tb;
      float acc[4][4], bon[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bon[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float rt[4], lp[4], kk[4], ls[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rt[i] = r_s[(tl + i) * P1 + d];
          lp[i] = lap_s[(tl + i) * P1 + d];
          kk[i] = k_s[(sl + i) * P1 + d];
          ls[i] = la_s[(sl + i) * P1 + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(rt[i] * kk[j], __expf(lp[i] - ls[j]), acc[i][j]);
        if (diag) {
          const float ud = u_s[d];
#pragma unroll
          for (int i = 0; i < 4; ++i) bon[i] = fmaf(rt[i] * kk[i], ud, bon[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tl + i, s = sl + j;
          sc_s[t * PC + s] = s < t ? acc[i][j] : (s == t ? bon[i] : 0.f);
        }
    }
    __syncthreads();
    // C: r_dec = r exp(la_prev) (into la_prev), k_dec = k exp(la_c - la)
    for (int i = tid; i < kC * D; i += kScanThreads) {
      const int t = i / D;
      const int j = t * P1 + (i - t * D);
      lap_s[j] = r_s[j] * __expf(lap_s[j]);
      k_s[j] = k_s[j] * __expf(lac_s[i - t * D] - la_s[j]);
    }
    __syncthreads();
    // D: o = r_dec S + scores v (the bonus rides on the diagonal)
    for (int tile = tid; tile < (kC / 4) * kTE; tile += kScanThreads) {
      const int tl = (tile / kTE) * 4;
      const int e0 = (tile % kTE) * 4;
      if (tl >= n) continue;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 sv = *reinterpret_cast<const float4*>(S_s + d * P4 + e0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = lap_s[(tl + i) * P1 + d];
          acc[i][0] = fmaf(a, sv.x, acc[i][0]);
          acc[i][1] = fmaf(a, sv.y, acc[i][1]);
          acc[i][2] = fmaf(a, sv.z, acc[i][2]);
          acc[i][3] = fmaf(a, sv.w, acc[i][3]);
        }
      }
      const int s_end = min(tl + 4, n);
      for (int s = 0; s < s_end; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + s * P4 + e0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = sc_s[(tl + i) * PC + s];
          acc[i][0] = fmaf(c, vv.x, acc[i][0]);
          acc[i][1] = fmaf(c, vv.y, acc[i][1]);
          acc[i][2] = fmaf(c, vv.z, acc[i][2]);
          acc[i][3] = fmaf(c, vv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (tl + i < n) {
          T* orow = ob + (long long)(t0 + tl + i) * os.s + e0;
#pragma unroll
          for (int j = 0; j < 4; ++j) orow[j] = from_f32<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the old S is done
    // E: S' = diag(exp(la_c)) S + k_dec^T v, one 4 x 4 tile per thread
    for (int tile = tid; tile < kTE * kTE; tile += kScanThreads) {
      const int d0 = (tile / kTE) * 4;
      const int e0 = (tile % kTE) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < n; ++s) {  // k_dec is zero past the sequence end
        const float4 vv = *reinterpret_cast<const float4*>(v_s + s * P4 + e0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kd = k_s[s * P1 + d0 + i];
          acc[i][0] = fmaf(kd, vv.x, acc[i][0]);
          acc[i][1] = fmaf(kd, vv.y, acc[i][1]);
          acc[i][2] = fmaf(kd, vv.z, acc[i][2]);
          acc[i][3] = fmaf(kd, vv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dec = __expf(lac_s[d0 + i]);
        float4* srow = reinterpret_cast<float4*>(S_s + (d0 + i) * P4 + e0);
        float4 sv = *srow;
        sv.x = dec * sv.x + acc[i][0];
        sv.y = dec * sv.y + acc[i][1];
        sv.z = dec * sv.z + acc[i][2];
        sv.w = dec * sv.w + acc[i][3];
        *srow = sv;
        if (last)
          *reinterpret_cast<float4*>(sf + bh * D * D + (d0 + i) * D + e0) = sv;
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* wl, const float* u, const float* s0, void* o,
                   float* sf, int B, int S, int H, const long long* st,
                   cudaStream_t stream) {
  const int bytes = ScanSmem<D>::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      os{st[12], st[13], st[14]};
  rwkv6_scan_kernel<T, D><<<B * H, kScanThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), wl, u, s0, static_cast<T*>(o), sf, S, H, rs,
      ks, vs, ws, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* r, const void* k, const void* v,
                       const float* wl, const float* u, const float* s0,
                       void* o, float* sf, int B, int S, int H,
                       const long long* st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, wl, u, s0, o, sf, B, S, H, st, stream);
    case 64:
      return launch<T, 64>(r, k, v, wl, u, s0, o, sf, B, S, H, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o share it; w_log, u, the
// states are f32).  strides: 15 int64 — (row, step, head) element strides of
// r, k, v, w_log and o, whose last axis is contiguous.  u is [H, D]
// contiguous; s0 (NULL: zeros) and sf are [B, H, D, D] contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const float* w_log, const float* u,
                              const float* s0, void* o, float* sf, int dtype,
                              int B, int S, int H, int D,
                              const long long* strides, void* stream) {
  using namespace flame;
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, r, k, v, w_log, u, s0, o, sf, B, S, H,
                             strides, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, r, k, v, w_log, u, s0, o, sf, B, S, H,
                                     strides, st);
  return cudaErrorInvalidValue;
}
