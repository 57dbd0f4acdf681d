// One-token decode attention for the continuous-batching slot pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pooled_bh, body _pooled_kernel). Same function: row b
// of q belongs to slot b / n_heads and reads key row b / G. Each slot has
// its own live length n = min(lengths[slot], L) and its own positions row
// (-1 marks an empty ring entry); column j is visible iff j < n and
// positions[slot, j] >= 0. There is no cur_pos test: the caller marks the
// ring entries a slot must not see -1. A null positions pointer means that
// column j holds position j (the FullKV layout), so nothing is read for it.
//
// What bounds it: the bytes of the live prefixes of K and V (one query
// token does two FMAs per cached element). Key tiles at or past
// ceil(n / 64) are never read, as the TPU kernel's index-map clamp elides
// their fetch, so a slot's traffic tracks its live length and not the
// buffer's capacity. This first version gives each row one thread block
// that streams its live tiles through shared memory; a later one splits a
// row's tiles across blocks so that more bytes are in flight.
//
// A row that sees no column (n = 0: a slot holding nothing) writes zeros,
// as the TPU kernel's acc / max(l, 1e-20) does with acc = 0 and l = 0.
#include "attention_common.cuh"

namespace flux {

constexpr int kPoolKeys = 64;

template <int D> struct PooledSmem {
  static constexpr int kLd = D + 1;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)D + (size_t)kPoolKeys * kLd +
                       (size_t)kPoolKeys * D + kPoolKeys + 4) +
      sizeof(int) * kPoolKeys;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
pooled_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ positions,
                     const int* __restrict__ lengths, T* __restrict__ o,
                     int L, int G, int n_heads, float scale) {
  extern __shared__ float smem[];
  constexpr int kLd = PooledSmem<D>::kLd;
  float* qs = smem;                   // (D,)
  float* ks = qs + D;                 // (64, D + 1)
  float* vs = ks + kPoolKeys * kLd;   // (64, D)
  float* ps = vs + kPoolKeys * D;     // (64,) scores, then probabilities
  float* stat = ps + kPoolKeys;       // running max, running sum, rescale
  int* pos_s = reinterpret_cast<int*>(stat + 4);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int slot = b / n_heads;
  const int n = min(max(lengths[slot], 0), L);  // the wrapper's clamp to L
  const int* prow =
      positions == nullptr ? nullptr : positions + (size_t)slot * L;
  const T* kr = k + (size_t)(b / G) * L * D;
  const T* vr = v + (size_t)(b / G) * L * D;
  for (int d = t; d < D; d += kThreads) qs[d] = to_float(q[(size_t)b * D + d]);
  if (t == 0) {
    stat[0] = kNegInf;
    stat[1] = 0.f;
  }
  float acc = 0.f;  // output column t (t < D)

  for (int key0 = 0; key0 < n; key0 += kPoolKeys) {  // live tiles only
    __syncthreads();  // the previous tile's reads are done
    for (int e = t; e < kPoolKeys * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int g = key0 + r;
      const bool in = g < n;
      ks[r * kLd + c] = in ? to_float(kr[(size_t)g * D + c]) : 0.f;
      vs[r * D + c] = in ? to_float(vr[(size_t)g * D + c]) : 0.f;
    }
    if (t < kPoolKeys) {
      const int g = key0 + t;
      pos_s[t] = g >= n ? -1 : (prow == nullptr ? g : prow[g]);
    }
    __syncthreads();

    if (t < kPoolKeys) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[d], ks[t * kLd + d], s);
      ps[t] = pos_s[t] >= 0 ? s * scale : kNegInf;
    }
    __syncthreads();

    if (t < 32) {  // warp 0: tile max, probabilities and their sum
      const float s0 = ps[t];
      const float s1 = ps[t + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = stat[0];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[t] = round_to<T>(p0);
      ps[t + 32] = round_to<T>(p1);
      __syncwarp();  // every lane has read stat[0]
      if (t == 0) {
        const float alpha = expf(m_old - m_new);
        stat[0] = m_new;
        stat[1] = stat[1] * alpha + sum;
        stat[2] = alpha;
      }
    }
    __syncthreads();

    if (t < D) {
      float a = acc * stat[2];
#pragma unroll 8
      for (int j = 0; j < kPoolKeys; ++j) a = fmaf(ps[j], vs[j * D + t], a);
      acc = a;
    }
  }
  __syncthreads();  // stat is written (n = 0 runs no tile)
  if (t < D) {
    // no visible column: the running max never left -1e30; write zeros
    const float out =
        stat[0] == kNegInf ? 0.f : acc / fmaxf(stat[1], 1e-20f);
    o[(size_t)b * D + t] = from_float<T>(out);
  }
}

template <typename T, int D> struct PooledLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* positions, const void* lengths, void* o,
                         int BH, int BHkv, int L, int n_heads, float scale,
                         cudaStream_t stream) {
    if (BH % BHkv != 0 || n_heads < 1 || BH % n_heads != 0)
      return cudaErrorInvalidValue;
    const size_t bytes = PooledSmem<D>::kBytes;
    auto kernel = pooled_decode_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<BH, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(positions),
        static_cast<const int*>(lengths), static_cast<T*>(o), L, BH / BHkv,
        n_heads, scale);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, 1, Dk), k (BHkv, L, Dk), v (BHkv, L, Dv), positions (B, L) int32
// or null, lengths (B,) int32, o (BH, 1, Dv), B = BH / n_heads. Built for
// Dk = Dv only; another pair returns cudaErrorInvalidValue. Returns a
// cudaError_t code.
extern "C" int decode_attention_pooled_fwd(const void* q, const void* k,
                                           const void* v,
                                           const void* positions,
                                           const void* lengths, void* o,
                                           int BH, int BHkv, int L, int Dk,
                                           int Dv, int n_heads, int dtype,
                                           float scale, void* stream) {
  if (Dk != Dv) return (int)cudaErrorInvalidValue;
  return flux::dispatch<flux::PooledLaunch>(
      dtype, Dk, q, k, v, positions, lengths, o, BH, BHkv, L, n_heads, scale,
      static_cast<cudaStream_t>(stream));
}
