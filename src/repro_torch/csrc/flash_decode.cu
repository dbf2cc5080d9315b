// GQA decode attention for Hopper (sm_90a) — kernel K4 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode/kernel.py::
// flash_decode_kernel (body _fd_kernel) in two forms.
//
// (a) flash_decode_self_fwd — the form generative decode runs.  q, k_self,
// v_self [B, M, H(kv), D]; caches [B, S, Hkv, D]; lengths [B].  Each of the M
// candidates of row b attends to cache positions [0, lengths[b]) plus its
// own key, never to the other candidates: ref.decode_with_self, which the
// TPU route realizes by writing each candidate's K/V into a private copy of
// its cache row and decoding lengths + 1 positions.  Here nothing is copied:
// this is K1's cached mode on a bf16 history without scales, so it runs
// K1's kernel (cached_score.cuh; bf16 on the tensor cores, f32 on the
// scalar kernel).  Bound: at the Climber decode shape (4 rows x 128
// candidates x 4 heads x 64 against ~258 keys) the unique bytes are ~1 MB
// (each beam's valid cache once, the candidates' q / K / V, the output):
// under a microsecond, so latency sets the time, as for K1.  A segment-
// packed decode dispatch passes a [B, M] row_index into stacked beam caches
// [U, S, Hkv, D] (lengths [U]): candidate (b, m) reads row row_index[b, m]
// in place (K1's packed passes), where the TPU route copies that row.
//
// (b) flash_decode_fwd — the single-token form of the TPU kernel (the text
// engine's attention kinds: gemma3-12b's `attn` layers decode through it,
// head dim 240 padded to 256 by the wrapper).  For every row b and query head h,
// softmax(q . k^T) v over the cache positions [max(0, len - window), len)
// of its KV head (window 0: [0, len)), len = lengths[b].  The softmax scale
// is folded into q by the wrapper at the unpadded head dim, as the TPU
// wrapper does.  A row with len == 0 gives zeros (acc / max(l, 1e-30)).
// Where the caller passes lse [B, H] f32, each (row, head) also gets the
// log of its softmax's sum, max + log(sum), natural units (-inf at len ==
// 0): the partial state a decode over a cache whose positions are split
// across ranks merges with the other ranks' (sharding.softmax_merge).
// Bound: bytes — each valid K / V element is read once and used for 4 G
// FLOPs; the least time is the valid K/V bytes over the memory rate.
// Design: one block of four warps per (row, KV head), all G query heads
// together (each K / V element read once per block).  The valid range is
// cut into 32-key chunks from its first position; chunk c goes to warp
// c % 4, which streams its chunks through its own two-slot cp.async ring
// of K / V kept in their stored type (16-byte loads, 16 per lane per
// chunk in flight while the previous chunk computes).  Lane j scores key j
// against the G queries (f32, q in shared memory), the warp folds the chunk
// into its online softmax (exponentials as 2^x with log2 e folded into q)
// and accumulates P V with each lane owning D / 32 output columns.  The four
// warps' states are combined in warp order at the end.  Head dims 32, 64,
// 128 and (bf16) 256; at 256 one chunk of K and V is 33 KB, so each warp's
// ring holds one chunk, and the four warps' loads overlap each other.  The chunks and their
// warps are fixed by len and window alone, so a padded cache decodes bitwise
// like the tight one and two calls agree bitwise.
#include "cached_score.cuh"

namespace flame {

// (row, head) element strides of q / o, whose last axis is contiguous.
struct Strides2 {
  long long n, h;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// xor butterfly: every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

namespace fd {

constexpr int kWarps = 4;
constexpr int kKeys = 32;  // keys per chunk: one per lane
constexpr int kMaxG = 16;  // query heads per KV head
constexpr int kMaxGD = 1024;

template <typename T, int D>
struct Cfg {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = D + EPC;  // row pitch: 16-byte reads of 8
                                      // consecutive rows hit distinct banks
  static constexpr int CPR = D / EPC;            // 16-byte chunks per row
  static constexpr int STAGE = 2 * kKeys * LD;   // K and V of one chunk
  static constexpr int NS =
      kWarps * 2 * STAGE * static_cast<int>(sizeof(T)) <= 160 * 1024 ? 2 : 1;
  static constexpr int RING = kWarps * NS * STAGE * static_cast<int>(sizeof(T));
  static constexpr int CPL = D / 32;  // output columns per lane
};

// Dynamic shared memory: the rings (after the loop: the warps' states for
// the combine), then the block's queries.
template <typename T, int D, int GM>
struct Smem {
  static constexpr int COMBINE = kWarps * GM * (D + 2) * 4;
  static constexpr int Q_AT =
      Cfg<T, D>::RING > COMBINE ? Cfg<T, D>::RING : COMBINE;
  static constexpr int BYTES = Q_AT + GM * D * 4;
};

template <typename T, int CPL>
__device__ __forceinline__ void load_cols(const T* p, float* out) {
#pragma unroll
  for (int c = 0; c < CPL; ++c) out[c] = to_f32(p[c]);
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kWarps * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, float* __restrict__ lse, int Hkv,
                  int G, Strides2 qs, Strides ks, Strides vs, Strides2 os,
                  int window) {
  using C = Cfg<T, D>;
  constexpr int EPC = C::EPC, LD = C::LD, CPR = C::CPR, CPL = C::CPL;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + Smem<T, D, GM>::Q_AT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;

  // the G queries of this KV head, f32, in base-2 units
  const T* qb = q + b * qs.n + (long long)kvh * G * qs.h;
  for (int i = tid; i < G * D; i += kWarps * 32) {
    const int gg = i / D;
    q_s[i] = to_f32(qb[gg * qs.h + (i - gg * D)]) * cs::kLog2e;
  }
  __syncthreads();

  const int nchunks = len > lo ? (len - lo + kKeys - 1) / kKeys : 0;
  const int nk = nchunks > warp ? (nchunks - warp + kWarps - 1) / kWarps : 0;
  T* my = ring + warp * C::NS * C::STAGE;
  const T* kb = k + b * ks.n + kvh * ks.h;
  const T* vb = v + b * vs.n + kvh * vs.h;
  const bool vec = ((reinterpret_cast<uintptr_t>(kb) |
                     reinterpret_cast<uintptr_t>(vb)) % 16 == 0) &&
                   (ks.s * (long long)sizeof(T)) % 16 == 0 &&
                   (vs.s * (long long)sizeof(T)) % 16 == 0;
  // the warp's kc-th chunk (global chunk warp + 4 kc) into its ring
  auto issue = [&](int kc) {
    const int t0 = lo + (warp + kc * kWarps) * kKeys;
    const int n = min(kKeys, len - t0);
    T* kd = my + (kc % C::NS) * C::STAGE;
    T* vd = kd + kKeys * LD;
    if (vec) {
      for (int e = lane; e < n * CPR; e += 32) {
        const int r = e / CPR, c = (e - r * CPR) * EPC;
        mma::cp_async16(kd + r * LD + c, kb + (long long)(t0 + r) * ks.s + c);
        mma::cp_async16(vd + r * LD + c, vb + (long long)(t0 + r) * vs.s + c);
      }
    } else {
      for (int e = lane; e < n * D; e += 32) {
        const int r = e / D, c = e - r * D;
        kd[r * LD + c] = kb[(long long)(t0 + r) * ks.s + c];
        vd[r * LD + c] = vb[(long long)(t0 + r) * vs.s + c];
      }
    }
  };

  float m[GM], l[GM], acc[GM][CPL];
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[gg][c] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < nk) issue(s);
    mma::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + C::NS - 1 < nk) issue(kc + C::NS - 1);
    mma::cp_async_commit();
    mma::cp_async_wait<C::NS - 1>();
    __syncwarp();
    const T* kt = my + (kc % C::NS) * C::STAGE;
    const T* vt = kt + kKeys * LD;
    const int n = min(kKeys, len - (lo + (warp + kc * kWarps) * kKeys));
    // scores: lane j against key j, two partial sums per query
    float s0[GM], s1[GM];
#pragma unroll
    for (int gg = 0; gg < GM; ++gg) s0[gg] = s1[gg] = 0.f;
    if (lane < n) {
      const T* kr = kt + lane * LD;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        float kf[EPC];
        Pack<T>::unpack(*reinterpret_cast<const uint4*>(kr + c * EPC), kf);
#pragma unroll
        for (int gg = 0; gg < GM; ++gg) {
          if (gg < G) {
            const float4* q4 =
                reinterpret_cast<const float4*>(q_s + gg * D + c * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 x = q4[e];
              s0[gg] = fmaf(x.x, kf[4 * e], s0[gg]);
              s1[gg] = fmaf(x.y, kf[4 * e + 1], s1[gg]);
              s0[gg] = fmaf(x.z, kf[4 * e + 2], s0[gg]);
              s1[gg] = fmaf(x.w, kf[4 * e + 3], s1[gg]);
            }
          }
        }
      }
    }
    // online softmax per query head over the chunk
    float p[GM];
#pragma unroll
    for (int gg = 0; gg < GM; ++gg) {
      p[gg] = 0.f;
      if (gg < G) {
        const float sc = lane < n ? s0[gg] + s1[gg] : kNegInf;
        const float mn = fmaxf(m[gg], warp_max(sc));  // n >= 1: finite
        const float corr = mma::ex2(m[gg] - mn);
        p[gg] = lane < n ? mma::ex2(sc - mn) : 0.f;
        l[gg] = l[gg] * corr + p[gg];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[gg][c] *= corr;
        m[gg] = mn;
      }
    }
    // O += P V: key j's weight from lane j, each lane its CPL columns
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float vf[CPL];
      load_cols<T, CPL>(vt + j * LD + lane * CPL, vf);
#pragma unroll
      for (int gg = 0; gg < GM; ++gg) {
        if (gg < G) {
          const float pj = __shfl_sync(0xffffffffu, p[gg], j);
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[gg][c] = fmaf(pj, vf[c], acc[gg][c]);
        }
      }
    }
    __syncwarp();  // every lane is done with this slot
  }
  mma::cp_async_wait<0>();

  // combine the four warps' states in warp order (the ring is reused)
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);  // [kWarps][GM] max
  float* cl = cm + kWarps * GM;                // [kWarps][GM] sum
  float* ca = cl + kWarps * GM;                // [kWarps][GM][D] acc
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
    if (gg < G) {
      const float lsum = warp_sum(l[gg]);
      if (lane == 0) {
        cm[warp * GM + gg] = m[gg];
        cl[warp * GM + gg] = lsum;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        ca[(warp * GM + gg) * D + lane * CPL + c] = acc[gg][c];
    }
  }
  __syncthreads();
  T* ob = o + b * os.n + (long long)kvh * G * os.h;
  for (int i = tid; i < G * D; i += kWarps * 32) {
    const int gg = i / D, d = i - gg * D;
    float mx = cm[gg];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, cm[w * GM + gg]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = mma::ex2(cm[w * GM + gg] - mx);
      lt = fmaf(cl[w * GM + gg], f, lt);
      at = fmaf(ca[(w * GM + gg) * D + d], f, at);
    }
    ob[gg * os.h + d] = from_f32<T>(at / fmaxf(lt, 1e-30f));
    // base-2 units back to natural: log(sum e^s) = ln 2 (max + log2 sum)
    if (lse && d == 0)
      lse[(b * Hkv + kvh) * G + gg] = (mx + log2f(lt)) * 0.69314718f;
  }
}

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* lse, int B, int Hkv,
                   int G, const long long* st, int window,
                   cudaStream_t stream) {
  const Strides2 qs{st[0], st[1]}, os{st[8], st[9]};
  const Strides ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  const int bytes = Smem<T, D, GM>::BYTES;
  auto kernel = decode_kernel<T, D, GM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), lse, Hkv, G, qs,
      ks, vs, os, window);
  return cudaGetLastError();
}

// dynamic shared bytes of the (b) kernel for head dim D and GM head slots
template <typename T>
int smem_of(int D, int gm) {
  auto pick = [gm](auto d) {
    constexpr int kD = decltype(d)::value;
    switch (gm) {
      case 1: return Smem<T, kD, 1>::BYTES;
      case 2: return Smem<T, kD, 2>::BYTES;
      case 4: return Smem<T, kD, 4>::BYTES;
      case 8: return Smem<T, kD, 8>::BYTES;
      default: return Smem<T, kD, 16>::BYTES;
    }
  };
  switch (D) {
    case 32: return pick(std::integral_constant<int, 32>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    case 128: return pick(std::integral_constant<int, 128>{});
    default: return pick(std::integral_constant<int, 256>{});
  }
}

// GM: query heads per KV head, rounded up to a power of two
inline int group_slots(int G) {
  int gm = 1;
  while (gm < G) gm <<= 1;
  return gm;
}

template <typename T, int D, int GM>
cudaError_t launch_if_fits(const void* q, const void* k, const void* v,
                           const int* lengths, void* o, float* lse, int B,
                           int Hkv, int G, const long long* st, int window,
                           cudaStream_t s) {
  if constexpr (GM * D <= kMaxGD)
    return launch<T, D, GM>(q, k, v, lengths, o, lse, B, Hkv, G, st, window,
                            s);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v,
                       const int* lengths, void* o, float* lse, int B,
                       int Hkv, int G, const long long* st, int window,
                       cudaStream_t s) {
  switch (group_slots(G)) {
    case 1:
      return launch_if_fits<T, D, 1>(q, k, v, lengths, o, lse, B, Hkv, G,
                                     st, window, s);
    case 2:
      return launch_if_fits<T, D, 2>(q, k, v, lengths, o, lse, B, Hkv, G,
                                     st, window, s);
    case 4:
      return launch_if_fits<T, D, 4>(q, k, v, lengths, o, lse, B, Hkv, G,
                                     st, window, s);
    case 8:
      return launch_if_fits<T, D, 8>(q, k, v, lengths, o, lse, B, Hkv, G,
                                     st, window, s);
    case 16:
      return launch_if_fits<T, D, 16>(q, k, v, lengths, o, lse, B, Hkv, G,
                                      st, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* lengths, void* o, float* lse, int B,
                       int Hkv, int G, const long long* st, int window,
                       cudaStream_t s) {
  switch (D) {
    case 32:
      return dispatch_g<T, 32>(q, k, v, lengths, o, lse, B, Hkv, G, st,
                               window, s);
    case 64:
      return dispatch_g<T, 64>(q, k, v, lengths, o, lse, B, Hkv, G, st,
                               window, s);
    case 128:
      return dispatch_g<T, 128>(q, k, v, lengths, o, lse, B, Hkv, G, st,
                                window, s);
    case 256:  // bf16 only: one f32 chunk per warp would pass 227 KB
      if constexpr (sizeof(T) == 2)
        return dispatch_g<T, 256>(q, k, v, lengths, o, lse, B, Hkv, G, st,
                                  window, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fd

template <typename T>
cudaError_t self_dispatch_d(int D, const ScoreArgs& a, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 16:
      return kBf16 ? launch_mma<__nv_bfloat16, 16>(a, s)
                   : launch_scalar<float, float, 16>(a, s);
    case 32:
      return kBf16 ? launch_mma<__nv_bfloat16, 32>(a, s)
                   : launch_scalar<float, float, 32>(a, s);
    case 64:
      return kBf16 ? launch_mma<__nv_bfloat16, 64>(a, s)
                   : launch_scalar<float, float, 64>(a, s);
    case 128:
      return kBf16 ? launch_mma<__nv_bfloat16, 128>(a, s)
                   : launch_scalar<float, float, 128>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// (b) dtype: 0 = float32, 1 = bfloat16 (q, caches and o share it).
// strides: 10 int64 — q (row, head); k (row, seq, head); v (row, seq, head);
// o (row, head); every last axis is contiguous.  lengths: B int32 on the
// device.  q is pre-scaled by the softmax scale.  lse: NULL, or [B, H]
// contiguous f32 for each (row, head)'s log-sum-exp.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, float* lse,
                                int dtype, int B, int H, int Hkv, int D,
                                const long long* strides, int window,
                                void* stream) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || window < 0 ||
      (long long)B * Hkv > 2147483647LL)
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (G > fd::kMaxG || G * D > fd::kMaxGD) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fd::dispatch_d<float>(D, q, k, v, lengths, o, lse, B, Hkv, G,
                                 strides, window, s);
  if (dtype == 1)
    return fd::dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, lse, B, Hkv,
                                         G, strides, window, s);
  return cudaErrorInvalidValue;
}

// (a) dtype: 0 = float32, 1 = bfloat16 (every operand and o).
// q, k_self, v_self, o [B, M, H(kv), D]; k, v [U, S, Hkv, D]; lengths [U]
// int32 on the device; row_index NULL (then U == B, candidate (b, m) on
// row b) or [B, M] int32 (segment-packed decode: a cache row per
// candidate).  strides: 18 int64 — (outer, seq, head) element strides of
// q, k, v, k_self, v_self, o.  scale: the softmax scale, applied in f32 to
// the scores (q is not pre-scaled).
extern "C" int flash_decode_self_fwd(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     const int* row_index,
                                     const void* k_self, const void* v_self,
                                     void* o, int dtype, int B, int M, int H,
                                     int Hkv, int U, int S, int D,
                                     const long long* strides, float scale,
                                     void* stream) {
  using namespace flame;
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 ||
      U <= 0 || (!row_index && U != B) || (long long)B * H > 65535LL)
    return cudaErrorInvalidValue;
  ScoreArgs a{q,         k,       v, nullptr, nullptr, k_self, v_self,
              row_index, lengths, o, B,       M,       H,      Hkv,
              U,         S,       {}, kCached, scale,  row_index != nullptr};
  for (int i = 0; i < 6; ++i)
    a.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return self_dispatch_d<float>(D, a, s);
  if (dtype == 1) return self_dispatch_d<__nv_bfloat16>(D, a, s);
  return cudaErrorInvalidValue;
}

// Launch plans: out[0..3] = grid x, grid y, threads per block, shared bytes
// (dynamic, except (a)'s f32 static bytes).  form 0 = (a) with M candidates,
// form 1 = (b) (M ignored).
extern "C" int flash_decode_plan(int form, int dtype, int B, int M, int H,
                                 int Hkv, int D, int* out) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (form == 0) {
    score_plan(dtype == 1, B, M, H, D, out);
    return cudaSuccess;
  }
  const int G = H / Hkv;
  if (G > fd::kMaxG || G * D > fd::kMaxGD) return cudaErrorInvalidValue;
  out[0] = B * Hkv;
  out[1] = 1;
  out[2] = fd::kWarps * 32;
  if (dtype != 1 && D > 128) return cudaErrorInvalidValue;
  out[3] = dtype == 1 ? fd::smem_of<__nv_bfloat16>(D, fd::group_slots(G))
                      : fd::smem_of<float>(D, fd::group_slots(G));
  return cudaSuccess;
}
