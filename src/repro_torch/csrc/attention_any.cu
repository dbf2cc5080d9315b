// Any-dims attention for Hopper (sm_90a): the variant of kernels K2
// (flash_attention) and K4 (flash_decode, both forms) that takes every head
// dim and group size their JAX wrappers take.
//
// Replaces, at the dims the tiled kernels are not instantiated for, the
// Pallas TPU kernels repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel and repro/kernels/flash_decode/kernel.py::
// flash_decode_kernel, whose wrappers pad D to the 128 lanes and so take any
// head dim.  The wrappers (kernels/flash_attention/ops.py, kernels/
// flash_decode/ops.py) send here, chosen from the dims before the launch:
//   K2: bf16 past head dim 256, f32 past 128 (every mask mode, q_offset);
//   K4 single-token: past 256, f32 past 128, or G > 16 or G * D > 1024;
//   K4 self-slot: past head dim 128.
// The launches count under the TPU kernel's wrapper, as K4's two forms do.
//
// One kernel serves the three forms.  A block owns kRows rows that read the
// same keys: 16 query positions of one head (K2), or the query heads of one
// KV head (K4: one decode token, or one candidate of the self-slot form).
// It walks the block's key range in tiles of kKeys keys:
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
// Bound on an H100: bytes for decode (each valid cache element read once),
// operations for prefill (4 Sq Sk D H FLOPs); this scalar f32 kernel runs
// on the CUDA cores (67 TFLOP/s), not the tensor cores, so it is far from
// either at prefill sizes.  It exists for dims no registry config uses;
// correctness first, as a first port.
#include "attention_common.cuh"

namespace flame {
namespace any_attn {

constexpr int kRows = 16;     // rows a block
constexpr int kKeys = 32;     // keys a tile (a lane each in the softmax)
constexpr int kSlice = 128;   // head-dim columns a scores pass stages
constexpr int kThreads = 256;
constexpr int kSmemMaxD = 2048;  // accumulators in shared memory up to it

enum Form { kK2 = 0, kDecode = 1, kSelf = 2 };
enum Mode { kFull = 0, kCausal = 1, kSliding = 2, kSumi = 3 };

struct Job {
  const void* q;
  const void* k;
  const void* v;
  const void* k_self;
  const void* v_self;
  void* o;
  float* ws;             // accumulators past kSmemMaxD (else nullptr)
  const int* lengths;    // decode forms: valid prefix per cache row
  const int* row_index;  // self form: [B, M] cache row per candidate
  int form, B, H, Hkv, Sq, Sk, D, M;
  Strides qs, ks, vs, kss, vss, os;
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
  Seg seg[2];
  const T* KS = K;  // key / value tensors of segment 1
  const T* VS = V;
  int mode = kFull;
  if (j.form == kK2) {
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
    mode = j.mode;
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
    seg[0] = Seg{kb, vb, j.ks.s, j.vs.s, lo0, hi0};
    seg[1] = Seg{kb, vb, j.ks.s, j.vs.s, lo1, hi1};
  } else {
    const int G = j.H / j.Hkv;
    const int kvh = blockIdx.y % j.Hkv;
    const int bm = blockIdx.y / j.Hkv;  // row (decode) or b * M + m (self)
    const int b = j.form == kSelf ? bm / j.M : bm;
    const int m = j.form == kSelf ? bm % j.M : 0;
    const int row = (j.form == kSelf && j.row_index) ? j.row_index[bm] : b;
    const int len = min(max(j.lengths[row], 0), j.Sk);
    if (tid < kRows) {
      const int g = r0 + tid;
      live[tid] = g < G;
      const int h = kvh * G + min(g, G - 1);
      qoff[tid] = b * j.qs.n + (long long)m * j.qs.s + h * j.qs.h;
      ooff[tid] = b * j.os.n + (long long)m * j.os.s + h * j.os.h;
      apos[tid] = len;
    }
    const int lo = (j.form == kDecode && j.window > 0)
                       ? max(0, len - j.window) : 0;
    seg[0] = Seg{row * j.ks.n + kvh * j.ks.h, row * j.vs.n + kvh * j.vs.h,
                 j.ks.s, j.vs.s, lo, len};
    seg[1] = Seg{0, 0, 0, 0, 0, 0};
    if (j.form == kSelf) {  // the candidate's own key, after its prefix
      KS = static_cast<const T*>(j.k_self);
      VS = static_cast<const T*>(j.v_self);
      seg[1] = Seg{b * j.kss.n + (long long)m * j.kss.s + kvh * j.kss.h,
                   b * j.vss.n + (long long)m * j.vss.s + kvh * j.vss.h, 0,
                   0, 0, 1};
    }
  }
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
    const T* Kp = (si ? KS : K) + s.koff;
    const T* Vp = (si ? VS : V) + s.voff;
    const bool self_seg = si == 1 && j.form == kSelf;
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
          const long long key = self_seg ? 0 : (long long)(t0 + t);
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
        const int col = self_seg ? apos[rr] : t0 + lane;
        const bool vis = lane < n && live[rr] &&
                         (j.form != kK2 || visible(mode, apos[rr], col,
                                                   j.window, j.n_history));
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
          const long long key = self_seg ? 0 : (long long)(t0 + t);
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
  j.form = kK2; j.B = B; j.H = H; j.Hkv = Hkv; j.Sq = Sq; j.Sk = Sk; j.D = D;
  j.M = 1;
  j.qs = strides3(strides); j.ks = strides3(strides + 3);
  j.vs = strides3(strides + 6); j.os = strides3(strides + 9);
  j.mode = mode; j.window = window; j.n_history = n_history;
  j.q_offset = q_offset; j.scale = scale;
  return run(j, dtype, (Sq + kRows - 1) / kRows, B * H, stream);
}

// K4 at any head dim and group size: one token per row (q [B, H, D], M = 1)
// or, with k_self / v_self, M candidates per row (q [B, M, H, D]) each
// seeing its cache row's valid prefix and its own key.  strides: 18 int64,
// (outer, seq, head) of q, k, v, k_self, v_self, o (q / o: (batch, M,
// head)).  lengths [rows] int32; row_index [B, M] int32 or null.  ws:
// [ceil(G / 16) * B * M * Hkv, 16, D] f32 past D 2048, else null.
extern "C" int attention_any_decode_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* row_index, const void* k_self, const void* v_self, void* o,
    void* ws, int dtype, int B, int M, int H, int Hkv, int S, int D,
    const long long* strides, int window, float scale, void* stream) {
  using namespace flame::any_attn;
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S < 0 ||
      window < 0 || !lengths)
    return cudaErrorInvalidValue;
  Job j{};
  j.q = q; j.k = k; j.v = v; j.k_self = k_self; j.v_self = v_self; j.o = o;
  j.ws = static_cast<float*>(ws);
  j.lengths = static_cast<const int*>(lengths);
  j.row_index = static_cast<const int*>(row_index);
  j.form = k_self ? kSelf : kDecode;
  j.B = B; j.H = H; j.Hkv = Hkv; j.Sq = 1; j.Sk = S; j.D = D; j.M = M;
  j.qs = strides3(strides); j.ks = strides3(strides + 3);
  j.vs = strides3(strides + 6); j.kss = strides3(strides + 9);
  j.vss = strides3(strides + 12); j.os = strides3(strides + 15);
  j.mode = kFull; j.window = window; j.scale = scale;
  const int G = H / Hkv;
  return run(j, dtype, (G + kRows - 1) / kRows, B * M * Hkv, stream);
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
