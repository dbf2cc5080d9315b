// Any-dims attention for Hopper (sm_90a): the variant of kernel K2
// (flash_attention) that takes every head dim its JAX wrapper takes.
//
// Replaces, at the head dims the tiled kernel is not instantiated for, the
// Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel, whose wrapper pads D to the 128 lanes and so
// takes any head dim.  The wrapper (kernels/flash_attention/ops.py) sends
// here bf16 past head dim 256 and f32 past 128, under every mask mode and
// q_offset, chosen from the dims before the launch; the launches count
// under flash_attention.  (K4's any-dims forms are decode_any.cu.)
//
// A block owns kRows = 16 query positions of one head and walks the keys
// they see in tiles of kKeys keys:
//   1. scores: D streamed in slices of kSlice columns through shared memory
//      (the rows' q slice, pre-scaled, and the tile's K slice as f32), each
//      thread summing two (row, key) dot products over the slice;
//   2. online softmax in f32, one warp per row, a lane per key: the running
//      max and sum per row in shared memory; a masked key's weight is set to
//      an exact 0, so a fully masked row gives zeros;
//   3. P V: each thread owns output columns, reads V's rows for them from
//      device memory (coalesced across the warp) and updates the rows' f32
//      accumulators, acc = acc * alpha + P V.
// The accumulators [kRows, D] live in shared memory up to head dim
// kSmemMaxD and past it in a device-memory workspace that the wrapper
// allocates (one [kRows, D] slab a block), so no head dim is refused.
// f32 arithmetic throughout; keys in a fixed order: two calls agree bitwise.
//
// Bound on an H100: operations (4 Sq Sk D H FLOPs); this scalar f32 kernel
// runs on the CUDA cores (67 TFLOP/s), not the tensor cores, so it is far
// from that at prefill sizes.  It exists for dims no registry config uses;
// correctness first, as a first port.
#include "attention_common.cuh"

namespace flame {
namespace any_attn {

constexpr int kRows = 16;     // rows a block
constexpr int kKeys = 32;     // keys a tile (a lane each in the softmax)
constexpr int kSlice = 128;   // head-dim columns a scores pass stages
constexpr int kThreads = 256;
constexpr int kSmemMaxD = 2048;  // accumulators in shared memory up to it

enum Mode { kFull = 0, kCausal = 1, kSliding = 2, kSumi = 3 };

struct Job {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;  // accumulators past kSmemMaxD (else nullptr)
  int B, H, Hkv, Sq, Sk, D;
  Strides qs, ks, vs, os;
  int mode, window, n_history, q_offset;
  float scale;
};

struct Seg {
  long long koff, voff;  // element offsets of key 0 of the segment
  long long kst, vst;    // element strides between keys
  int lo, hi;            // keys [lo, hi), absolute positions
};

__device__ __forceinline__ bool visible(int mode, int a, int col, int window,
                                        int n_history) {
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
}

__host__ __device__ inline size_t smem_bytes(int D) {
  const size_t base = kRows * kSlice + kKeys * (kSlice + 1) +
                      kRows * kKeys + 3 * kRows;
  return (base + (D <= kSmemMaxD ? (size_t)kRows * D : 0)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_any_kernel(Job j) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [kRows][kSlice]
  float* kt = qs + kRows * kSlice;         // [kKeys][kSlice + 1]
  float* sc = kt + kKeys * (kSlice + 1);   // [kRows][kKeys]
  float* mrow = sc + kRows * kKeys;        // running max
  float* lrow = mrow + kRows;              // running sum
  float* arow = lrow + kRows;              // this tile's rescale
  __shared__ long long qoff[kRows], ooff[kRows];
  __shared__ int apos[kRows], live[kRows];

  const int D = j.D;
  const int tid = threadIdx.x;
  const long long slab =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kRows * D;
  float* acc = j.ws ? j.ws + slab : arow + kRows;  // [kRows][D]
  const T* Q = static_cast<const T*>(j.q);
  const T* K = static_cast<const T*>(j.k);
  const T* V = static_cast<const T*>(j.v);
  T* O = static_cast<T*>(j.o);

  // ---- the block's rows and key segments ----
  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y / j.H, h = blockIdx.y % j.H;
  const int kvh = h / (j.H / j.Hkv);
  const int r1 = min(r0 + kRows, j.Sq);
  if (tid < kRows) {
    const int r = r0 + tid;
    live[tid] = r < j.Sq;
    const int rc = min(r, j.Sq - 1);
    qoff[tid] = b * j.qs.n + (long long)rc * j.qs.s + h * j.qs.h;
    ooff[tid] = b * j.os.n + (long long)rc * j.os.s + h * j.os.h;
    apos[tid] = r + j.q_offset;
  }
  const int mode = j.mode;
  int lo0 = 0, hi0 = j.Sk, lo1 = 0, hi1 = 0;
  const int diag = min(j.Sk, j.q_offset + r1);
  if (mode == kCausal) {
    hi0 = diag;
  } else if (mode == kSliding) {
    lo0 = max(0, r0 + j.q_offset - j.window + 1);
    hi0 = diag;
  } else if (mode == kSumi) {
    hi0 = min(j.n_history, diag);
    lo1 = max(j.n_history, j.q_offset + r0);
    hi1 = diag;
  }
  const long long kb = b * j.ks.n + kvh * j.ks.h;
  const long long vb = b * j.vs.n + kvh * j.vs.h;
  Seg seg[2];
  seg[0] = Seg{kb, vb, j.ks.s, j.vs.s, lo0, hi0};
  seg[1] = Seg{kb, vb, j.ks.s, j.vs.s, lo1, hi1};
  if (tid < kRows) {
    mrow[tid] = kNegInf;
    lrow[tid] = 0.f;
  }
  for (int i = tid; i < kRows * D; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int pr = tid / kKeys;  // scores: rows pr and pr + 8, key pc
  const int pc = tid % kKeys;
  const int warp = tid / 32, lane = tid % 32;
  for (int si = 0; si < 2; ++si) {
    const Seg s = seg[si];
    const T* Kp = K + s.koff;
    const T* Vp = V + s.voff;
    for (int t0 = s.lo; t0 < s.hi; t0 += kKeys) {
      const int n = min(kKeys, s.hi - t0);
      // 1. scores, D in slices through shared memory
      float s0 = 0.f, s1 = 0.f;
      for (int d0 = 0; d0 < D; d0 += kSlice) {
        const int w = min(kSlice, D - d0);
        __syncthreads();
        for (int i = tid; i < kRows * kSlice; i += kThreads) {
          const int r = i / kSlice, c = i % kSlice;
          qs[i] = (live[r] && c < w)
                      ? to_f32(Q[qoff[r] + d0 + c]) * j.scale : 0.f;
        }
        for (int i = tid; i < kKeys * kSlice; i += kThreads) {
          const int t = i / kSlice, c = i % kSlice;
          const long long key = t0 + t;
          kt[t * (kSlice + 1) + c] =
              (t < n && c < w) ? to_f32(Kp[key * s.kst + d0 + c]) : 0.f;
        }
        __syncthreads();
        const float* k_row = kt + pc * (kSlice + 1);
        const float* q0 = qs + pr * kSlice;
        const float* q1 = qs + (pr + 8) * kSlice;
#pragma unroll 8
        for (int c = 0; c < kSlice; ++c) {
          const float kv = k_row[c];
          s0 = fmaf(q0[c], kv, s0);
          s1 = fmaf(q1[c], kv, s1);
        }
      }
      sc[pr * kKeys + pc] = s0;
      sc[(pr + 8) * kKeys + pc] = s1;
      __syncthreads();
      // 2. online softmax: warp w takes rows w and w + 8, lane = key
      for (int rr = warp; rr < kRows; rr += kThreads / 32) {
        const int col = t0 + lane;
        const bool vis = lane < n && live[rr] &&
                         visible(mode, apos[rr], col, j.window, j.n_history);
        const float x = vis ? sc[rr * kKeys + lane] : kNegInf;
        float mx = x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = mrow[rr];
        const float m_new = fmaxf(m_old, mx);
        const float p = vis ? expf(x - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sc[rr * kKeys + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          arow[rr] = alpha;
          lrow[rr] = lrow[rr] * alpha + sum;
          mrow[rr] = m_new;
        }
      }
      __syncthreads();
      // 3. acc = acc * alpha + P V, a thread per output column
      for (int c = tid; c < D; c += kThreads) {
        float a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = 0.f;
        for (int t = 0; t < n; ++t) {
          const long long key = t0 + t;
          const float vv = to_f32(Vp[key * s.vst + c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            a[r] = fmaf(sc[r * kKeys + t], vv, a[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r * D + c] = fmaf(acc[r * D + c], arow[r], a[r]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (live[r]) O[ooff[r] + c] = from_f32<T>(acc[i] / fmaxf(lrow[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const Job& j, int row_tiles, int groups,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(j.D);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  attention_any_kernel<T><<<dim3(row_tiles, groups), kThreads, bytes,
                            stream>>>(j);
  return cudaGetLastError();
}

}  // namespace any_attn
}  // namespace flame

using flame::Strides;
using flame::any_attn::Job;

static Strides strides3(const long long* s) {
  return Strides{s[0], s[1], s[2]};
}

static int run(Job& j, int dtype, int row_tiles, int groups, void* stream) {
  using namespace flame::any_attn;
  if (row_tiles <= 0 || groups <= 0 || groups > 65535 || j.D <= 0 ||
      (j.D > kSmemMaxD) != (j.ws != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(j, row_tiles, groups, s);
  if (dtype == 1) return launch<__nv_bfloat16>(j, row_tiles, groups, s);
  return cudaErrorInvalidValue;
}

// K2 at any head dim.  strides: 12 int64, (batch, seq, head) element strides
// of q, k, v, o.  ws: [ceil(Sq / 16) * B * H, 16, D] f32 past D 2048, else
// null.
extern "C" int attention_any_k2_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* ws,
                                    int dtype, int B, int H, int Hkv, int Sq,
                                    int Sk, int D, const long long* strides,
                                    int mode, int window, int n_history,
                                    int q_offset, float scale, void* stream) {
  using namespace flame::any_attn;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 ||
      mode < kFull || mode > kSumi)
    return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.k = k; j.v = v; j.o = o;
  j.ws = static_cast<float*>(ws);
  j.B = B; j.H = H; j.Hkv = Hkv; j.Sq = Sq; j.Sk = Sk; j.D = D;
  j.qs = strides3(strides); j.ks = strides3(strides + 3);
  j.vs = strides3(strides + 6); j.os = strides3(strides + 9);
  j.mode = mode; j.window = window; j.n_history = n_history;
  j.q_offset = q_offset; j.scale = scale;
  return run(j, dtype, (Sq + kRows - 1) / kRows, B * H, stream);
}

// Launch plan: out = grid x, grid y, threads, dynamic shared bytes.
extern "C" int attention_any_plan(int row_tiles, int groups, int D, int* out) {
  using namespace flame::any_attn;
  if (row_tiles <= 0 || groups <= 0 || D <= 0) return cudaErrorInvalidValue;
  out[0] = row_tiles;
  out[1] = groups;
  out[2] = kThreads;
  out[3] = (int)smem_bytes(D);
  return cudaSuccess;
}
