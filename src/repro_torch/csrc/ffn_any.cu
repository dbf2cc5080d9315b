// Any-dims fused (RMSNorm +) FFN for Hopper (sm_90a): the variant of kernel
// K3 (fused_ffn) that takes every model dim and d_ff its JAX wrapper takes.
//
// Replaces, at the dims the tiled kernels are not instantiated for, the
// Pallas TPU kernel repro/kernels/fused_ffn/kernel.py::fused_ffn_kernel,
// whose wrapper pads T and d_ff to its blocks and so takes any d and d_ff.
// The wrapper (kernels/fused_ffn/ops.py) sends here, chosen from the dims
// before the launch: f32 operands at a model dim outside {64, 256}, and bf16
// operands whose d or d_ff is not a multiple of 8 (the wide form's 16-byte
// rows).  Its launches count under fused_ffn_2d.
//
// It computes n(x) = x * rsqrt(mean(x^2) + 1e-6) * (1 + scale) (optional),
// h = act(n(x) W_up) (swiglu: silu(n(x) W_gate) * n(x) W_up), out = h W_down,
// all in f32 and rounded to the operands' dtype once.  Two kernels:
//   1. ffn_any_kernel: a block owns kRows rows and one slice of d_ff; for
//      each kCols columns of its slice it streams d in kSlice-wide pieces
//      through shared memory (the rows' normalized x and the W_up / W_gate
//      tile), forms the [kRows, kCols] hidden with the activation in shared
//      memory (it never reaches device memory), and adds hidden W_down to
//      the rows' f32 partial sum of its slice, in a workspace [slices, T, d];
//   2. ffn_any_reduce: out = the slices' partials summed in slice order.
// The slices spread small T over the SMs: the wrapper picks their count
// from T and d_ff.  No atomics: two calls agree bitwise.
//
// Bound on an H100: operations past a few hundred rows (4 T d d_ff FLOPs,
// 6 with a gate), the weights' bytes below.  This scalar f32 kernel runs on
// the CUDA cores (67 TFLOP/s), not the tensor cores: it exists for dims no
// registry config uses; correctness first, as a first port.
#include "attention_common.cuh"

namespace flame {
namespace any_ffn {

constexpr int kRows = 16;
constexpr int kCols = 64;    // d_ff columns a step
constexpr int kSlice = 64;   // model-dim columns a staged piece
constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;

enum Act { kGelu = 0, kRelu = 1, kSwiglu = 2 };

__device__ __forceinline__ float act_of(int act, float up, float gate) {
  if (act == kSwiglu) return gate / (1.f + expf(-gate)) * up;
  if (act == kRelu) return fmaxf(up, 0.f);
  const float c = 0.7978845608028654f;  // sqrt(2 / pi): gelu, tanh form
  return 0.5f * up * (1.f + tanhf(c * (up + 0.044715f * up * up * up)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffn_any_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ w_up, const T* __restrict__ w_gate,
                   const T* __restrict__ w_down, float* __restrict__ part,
                   int Tn, int d, int F, int act, int slice_cols) {
  __shared__ float xs[kRows][kSlice];
  __shared__ float wu[kSlice][kCols + 1];
  __shared__ float wg[kSlice][kCols + 1];
  __shared__ float hid[kRows][kCols];
  __shared__ float inv[kRows];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int f_lo = blockIdx.y * slice_cols;
  const int f_hi = min(F, f_lo + slice_cols);
  const int warp = tid / 32, lane = tid % 32;
  const bool gated = act == kSwiglu;

  // rows' inverse RMS (1 without the norm): warp w takes rows w and w + 8
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float ss = 0.f;
    if (scale && r0 + r < Tn)
      for (int c = lane; c < d; c += 32) {
        const float v = to_f32(x[(long long)(r0 + r) * d + c]);
        ss = fmaf(v, v, ss);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv[r] = scale ? rsqrtf(ss / d + kEps) : 1.f;
  }
  // this block's rows of its slice's partial sum start at zero
  float* out = part + ((long long)blockIdx.y * Tn + r0) * d;
  const int rows = min(kRows, Tn - r0);
  for (int i = tid; i < rows * d; i += kThreads) out[i] = 0.f;
  __syncthreads();

  const int hc = tid % kCols;      // hidden column of this thread
  const int hr = tid / kCols;      // rows hr, hr + 4, hr + 8, hr + 12
  for (int f0 = f_lo; f0 < f_hi; f0 += kCols) {
    const int nf = min(kCols, f_hi - f0);
    float up[4] = {0.f, 0.f, 0.f, 0.f}, gt[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < d; d0 += kSlice) {
      const int w = min(kSlice, d - d0);
      __syncthreads();
      for (int i = tid; i < kRows * kSlice; i += kThreads) {
        const int r = i / kSlice, c = i % kSlice;
        float v = 0.f;
        if (r0 + r < Tn && c < w) {
          v = to_f32(x[(long long)(r0 + r) * d + d0 + c]) * inv[r];
          if (scale) v *= 1.f + to_f32(scale[d0 + c]);
        }
        xs[r][c] = v;
      }
      for (int i = tid; i < kSlice * kCols; i += kThreads) {
        const int k = i / kCols, c = i % kCols;
        const bool in = k < w && c < nf;
        const long long at = (long long)(d0 + k) * F + f0 + c;
        wu[k][c] = in ? to_f32(w_up[at]) : 0.f;
        if (gated) wg[k][c] = in ? to_f32(w_gate[at]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kSlice; ++k) {
        const float u = wu[k][hc];
        const float g = gated ? wg[k][hc] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[hr + 4 * i][k];
          up[i] = fmaf(xv, u, up[i]);
          gt[i] = fmaf(xv, g, gt[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hid[hr + 4 * i][hc] = hc < nf ? act_of(act, up[i], gt[i]) : 0.f;
    __syncthreads();
    // the rows' partial += hidden W_down, a thread per output column
    for (int c = tid; c < d; c += kThreads) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = 0.f;
      for (int j = 0; j < nf; ++j) {
        const float wv = to_f32(w_down[(long long)(f0 + j) * d + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = fmaf(hid[r][j], wv, a[r]);
      }
      for (int r = 0; r < rows; ++r) out[(long long)r * d + c] += a[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffn_any_reduce(const float* __restrict__ part, T* __restrict__ out,
                   long long n, int slices) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[k * n + i];
  out[i] = from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* w_up,
                   const void* w_gate, const void* w_down, void* out,
                   float* part, int Tn, int d, int F, int act, int slice_cols,
                   cudaStream_t stream) {
  const int slices = (F + slice_cols - 1) / slice_cols;
  ffn_any_kernel<T><<<dim3((Tn + kRows - 1) / kRows, slices), kThreads, 0,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(w_up), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_down), part, Tn, d, F, act, slice_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)Tn * d;
  ffn_any_reduce<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(part, static_cast<T*>(out), n, slices);
  return cudaGetLastError();
}

}  // namespace any_ffn
}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (every operand).  x [T, d], scale [d] or
// null, w_up / w_gate [d, F] (w_gate null unless act = swiglu), w_down
// [F, d], out [T, d], all row-major; part: the f32 workspace [ceil(F /
// slice_cols), T, d]; slice_cols a multiple of 64.
extern "C" int ffn_any_fwd(const void* x, const void* scale, const void* w_up,
                           const void* w_gate, const void* w_down, void* out,
                           void* part, int dtype, int T, int d, int F, int act,
                           int slice_cols, void* stream) {
  using namespace flame::any_ffn;
  if (T <= 0 || d <= 0 || F <= 0 || act < kGelu || act > kSwiglu ||
      (act == kSwiglu) != (w_gate != nullptr) || slice_cols <= 0 ||
      slice_cols % kCols || (F + slice_cols - 1) / slice_cols > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float>(x, scale, w_up, w_gate, w_down, out, p, T, d, F, act,
                         slice_cols, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, w_up, w_gate, w_down, out, p, T,
                                 d, F, act, slice_cols, s);
  return cudaErrorInvalidValue;
}
