// Mask-aware GQA flash attention for Hopper (sm_90a) — kernel K2 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _fa_kernel).  It computes the same function:
// softmax(q k^T / sqrt(D)) v per (batch, head) with GQA head groups, under one
// of four masks — full, causal, sliding (window), sumi (n_history causal
// rows, candidates see history + self) — with q_offset placing query row i
// at absolute key position q_offset + i (sumi and causal).
//
// Design (see attention_common.cuh): one block of kRows threads per
// (batch * head, q tile), one thread per query row.  The block walks only the
// key ranges its q tile can see under the mask (the TPU kernel's block
// skipping, done here as loop bounds), staging f32 K/V tiles in shared
// memory.  Nothing carries over between blocks, so the TPU kernel's
// sequential-grid accumulator scratch becomes per-thread registers.  No
// padding of D to 128 lanes, no square blocks, no bq <= bk restriction.
//
// Bound: at the Climber encode shapes ([4, 257, 4, 64] bf16) the function
// moves ~1 MB and does ~0.27 GFLOP, under a microsecond either way on an
// H100; this first version computes with scalar f32 FMAs on few blocks and is
// limited by latency and launch overhead, not by either roofline.  Tensor-core
// (wgmma) tiles and batching the layers into fewer launches are later work.
#include "attention_common.cuh"

namespace flame {

enum Mode { kFull = 0, kCausal = 1, kSliding = 2, kSumi = 3 };

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                           Strides vs, Strides os, int mode, int window,
                           int n_history, int q_offset, float scale) {
  constexpr int BK = Tile<D>::keys;
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, Sq);  // exclusive end of this q tile
  const int r = r0 + threadIdx.x;
  const bool live = r < Sq;
  const int a = r + q_offset;  // absolute key position of this query row

  Row<D> st;
  st.reset();
  st.load_q(q + b * qs.n + h * qs.h + (long long)(live ? r : r0) * qs.s, live,
            scale);

  auto visible = [&](int col) -> bool {
    if (!live) return false;
    switch (mode) {
      case kFull:
        return true;
      case kCausal:
        return col <= a;
      case kSliding:
        return col <= a && a - col < window;
      default:  // kSumi
        return a < n_history ? col <= a : (col < n_history || col == a);
    }
  };

  // key ranges [lo, hi) this q tile can see (uniform over the block)
  int lo0 = 0, hi0 = Sk, lo1 = 0, hi1 = 0;
  const int diag = min(Sk, q_offset + r1);  // one past the last row's own key
  if (mode == kCausal) {
    hi0 = diag;
  } else if (mode == kSliding) {
    lo0 = max(0, r0 + q_offset - window + 1);
    hi0 = diag;
  } else if (mode == kSumi) {
    hi0 = min(n_history, diag);                 // history keys
    lo1 = max(n_history, q_offset + r0);        // the rows' own keys
    hi1 = diag;
  }

  const T* kb = k + b * ks.n + kvh * ks.h;
  const T* vb = v + b * vs.n + kvh * vs.h;
  for (int seg = 0; seg < 2; ++seg) {
    const int lo = seg ? lo1 : lo0;
    const int hi = seg ? hi1 : hi0;
    for (int t0 = lo; t0 < hi; t0 += BK) {
      const int n = min(BK, hi - t0);
      __syncthreads();
      load_tile<T, D>(k_tile, kb + t0 * ks.s, ks.s, n, 1.f);
      load_tile<T, D>(v_tile, vb + t0 * vs.s, vs.s, n, 1.f);
      __syncthreads();
      st.fold(k_tile, v_tile, n, [&](int t) { return visible(t0 + t); });
    }
  }
  if (live) st.store(o + b * os.n + h * os.h + (long long)r * os.s);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, const Strides* st,
                   int mode, int window, int n_history, int q_offset,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_attention_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, st[0],
      st[1], st[2], st[3], mode, window, n_history, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int Hkv, int Sq, int Sk,
                       const Strides* st, int mode, int window, int n_history,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                            n_history, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides: 12 int64 — (batch, seq, head) element strides of q, k, v, o.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hkv,
                                   int Sq, int Sk, int D,
                                   const long long* strides, int mode,
                                   int window, int n_history, int q_offset,
                                   float scale, void* stream) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 ||
      mode < kFull || mode > kSumi)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st, mode,
                             window, n_history, q_offset, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                     mode, window, n_history, q_offset, scale,
                                     s);
  return cudaErrorInvalidValue;
}
