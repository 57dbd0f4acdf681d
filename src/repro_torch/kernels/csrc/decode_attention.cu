// One-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_bh, body _kernel). Same function: the query of row b
// attends the cache of key row b / G at the slots whose position p has
// p >= 0 and p <= cur_pos (-1 marks an empty ring slot), with the online
// softmax over key tiles. One positions vector (L,) is shared by all rows,
// so one kernel serves the full cache (positions = arange) and the
// sink + local ring (positions = the ring's own) of the serving decode.
//
// What bounds it: the bytes of K and V it reads (one query token does two
// FMAs per cached element), so the least time is the cache bytes over the
// memory rate. This first version gives each (b, h) row one thread block
// that streams its cache in 64-key tiles through shared memory; a later
// one splits the cache across blocks so that more bytes are in flight.
#include "attention_common.cuh"

namespace flux {

constexpr int kDecKeys = 64;

template <int D> struct DecodeSmem {
  static constexpr int kLd = D + 1;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)D + (size_t)kDecKeys * kLd +
                       (size_t)kDecKeys * D + kDecKeys + 4) +
      sizeof(int) * kDecKeys;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ positions,
              T* __restrict__ o, int L, int G, int cur_pos, float scale) {
  extern __shared__ float smem[];
  constexpr int kLd = DecodeSmem<D>::kLd;
  float* qs = smem;                  // (D,)
  float* ks = qs + D;                // (64, D + 1)
  float* vs = ks + kDecKeys * kLd;   // (64, D)
  float* ps = vs + kDecKeys * D;     // (64,) scores, then probabilities
  float* stat = ps + kDecKeys;       // running max, running sum, rescale
  int* pos_s = reinterpret_cast<int*>(stat + 4);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const T* kr = k + (size_t)(b / G) * L * D;
  const T* vr = v + (size_t)(b / G) * L * D;
  for (int d = t; d < D; d += kThreads) qs[d] = to_float(q[(size_t)b * D + d]);
  if (t == 0) {
    stat[0] = kNegInf;
    stat[1] = 0.f;
  }
  float acc = 0.f;  // output column t (t < D)

  for (int key0 = 0; key0 < L; key0 += kDecKeys) {
    __syncthreads();  // the previous tile's reads are done
    for (int e = t; e < kDecKeys * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int g = key0 + r;
      const bool in = g < L;
      ks[r * kLd + c] = in ? to_float(kr[(size_t)g * D + c]) : 0.f;
      vs[r * D + c] = in ? to_float(vr[(size_t)g * D + c]) : 0.f;
    }
    if (t < kDecKeys) pos_s[t] = key0 + t < L ? positions[key0 + t] : -1;
    __syncthreads();

    if (t < kDecKeys) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[d], ks[t * kLd + d], s);
      const int p = pos_s[t];
      ps[t] = (p >= 0 && p <= cur_pos) ? s * scale : kNegInf;
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
      for (int j = 0; j < kDecKeys; ++j) a = fmaf(ps[j], vs[j * D + t], a);
      acc = a;
    }
  }
  if (t < D) o[(size_t)b * D + t] = from_float<T>(acc / fmaxf(stat[1], 1e-20f));
}

template <typename T, int D> struct DecodeLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* positions, void* o, int BH, int BHkv,
                         int L, int cur_pos, float scale,
                         cudaStream_t stream) {
    const size_t bytes = DecodeSmem<D>::kBytes;
    auto kernel = decode_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<BH, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(positions),
        static_cast<T*>(o), L, BH / BHkv, cur_pos, scale);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, 1, D), k / v (BHkv, L, D), positions (L,) int32, o (BH, 1, D).
// Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* positions,
                                    void* o, int BH, int BHkv, int L, int D,
                                    int dtype, int cur_pos, float scale,
                                    void* stream) {
  return flux::dispatch<flux::DecodeLaunch>(
      dtype, D, q, k, v, positions, o, BH, BHkv, L, cur_pos, scale,
      static_cast<cudaStream_t>(stream));
}
