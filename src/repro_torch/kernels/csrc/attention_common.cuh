// Shared pieces of the Hopper attention kernels (sm_90a, plain C interface).
//
// Every kernel here computes what its Pallas TPU counterpart computes:
// fp32 scores and accumulators, the mask value -1e30 (not -inf), p rounded
// to v's dtype before the PV product, and the final acc / max(l, 1e-20).
// Inputs are fp32 or bf16 (one template instance each) with head dims 32,
// 64, 96 and 128. Kernels allocate nothing and launch on the caller's
// stream; each C entry point returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace flux {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kF32 = 0;   // dtype codes shared with kernels/_build.py
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p.astype(v.dtype) as a float: the rounding the TPU kernels apply to the
// probabilities before the PV product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Floor division for a possibly negative numerator and b > 0. C's `/`
// truncates toward zero, Python's `//` floors.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return q * b > a ? q - 1 : q;
}

__device__ __forceinline__ float warp_max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Prefill tile engine: one thread block owns kBQ query rows of one (b, h)
// row and walks a caller-chosen sequence of kBK-key tiles, keeping the
// online softmax state in registers. 256 threads form a 16 x 16 grid; thread
// (ty, tx) owns score rows ty + 16 i and key columns tx + 16 j (i, j < 4),
// and output columns tx + 16 j (j < D / 16). Tiles are staged in shared
// memory as fp32 with an odd row stride, so column reads are conflict-free.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D> struct PrefillSmem {
  static constexpr int kLd = D + 1;
  static constexpr int kPLd = kBK + 1;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * kLd + (size_t)kBQ * kPLd);
};

template <typename T, int D> struct PrefillBlock {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static constexpr int kLd = PrefillSmem<D>::kLd;
  static constexpr int kPLd = PrefillSmem<D>::kPLd;
  static constexpr int kCols = D / 16;

  float* qs;
  float* ks;
  float* vs;
  float* ps;
  int tx, ty;
  float m[4], l[4], acc[4][kCols];

  __device__ void init(float* smem) {
    qs = smem;
    ks = qs + kBQ * kLd;
    vs = ks + kBK * kLd;
    ps = vs + kBK * kLd;
    tx = threadIdx.x % 16;
    ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    }
  }

  // Rows [row0, row0 + 64) of a row-major (n, D) matrix into a staged tile;
  // rows at or past n read as zeros (the TPU kernels pad with zeros).
  __device__ static void load_tile(float* dst, const T* src, int row0, int n) {
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int g = row0 + r;
      dst[r * kLd + c] = g < n ? to_float(src[(size_t)g * D + c]) : 0.f;
    }
  }

  __device__ void load_q(const T* q, int row0, int n) { load_tile(qs, q, row0, n); }

  // One kBK-key tile at keys [kv0, kv0 + 64). mask(r, key) says whether the
  // query row r of this block (0..63) sees the absolute key index `key`.
  template <class Mask>
  __device__ void step(const T* k, const T* v, int kv0, int n_kv, float scale,
                       const Mask& mask) {
    __syncthreads();  // the previous tile's reads of ks / vs / ps are done
    load_tile(ks, k, kv0, n_kv);
    load_tile(vs, v, kv0, n_kv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask(r, kv0 + tx + 16 * j) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max16(mx);  // the 16 threads of row r share one warp
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[r * kPLd + tx + 16 * j] = round_to<T>(p);
      }
      rs = warp_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float b[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) b[c] = vs[key * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kPLd + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, b[c], acc[i][c]);
      }
    }
  }

  __device__ void store(T* o, int row0, int n) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = row0 + ty + 16 * i;
      if (g >= n) continue;
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o[(size_t)g * D + tx + 16 * c] = from_float<T>(acc[i][c] / denom);
    }
  }
};

// Raises the kernel's dynamic shared-memory cap (above 48 KB it must be
// asked for explicitly).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dtype x head-dim dispatch onto Launcher<T, D>::run(args...).
template <template <typename, int> class Launcher, typename T, typename... A>
cudaError_t dispatch_head_dim(int D, A... a) {
  switch (D) {
    case 32: return Launcher<T, 32>::run(a...);
    case 64: return Launcher<T, 64>::run(a...);
    case 96: return Launcher<T, 96>::run(a...);
    case 128: return Launcher<T, 128>::run(a...);
  }
  return cudaErrorInvalidValue;
}

// dtype x head-dim dispatch with one launcher per dtype: fp32 operands go
// to F32Launcher<float, D>, bf16 operands to BF16Launcher<__nv_bfloat16, D>.
template <template <typename, int> class F32Launcher,
          template <typename, int> class BF16Launcher, typename... A>
int dispatch_by_dtype(int dtype, int D, A... a) {
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kF32) e = dispatch_head_dim<F32Launcher, float>(D, a...);
  if (dtype == kBF16)
    e = dispatch_head_dim<BF16Launcher, __nv_bfloat16>(D, a...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call reports its own
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <template <typename, int> class Launcher, typename... A>
int dispatch(int dtype, int D, A... a) {
  return dispatch_by_dtype<Launcher, Launcher>(dtype, D, a...);
}

}  // namespace flux

extern "C" const char* flux_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
