// What the split-KV decode kernels for Hopper (sm_90a) share: the batch
// decode kernel (decode_attention.cu) and the slot pool's
// (decode_attention_pooled.cu) each run one CTA per range of whole 64-key
// tiles of one KV row, with this tile size, shared-memory plan, TMA bulk
// and cp.async loads, 16-byte shared-memory reads and CTA reductions.
#pragma once

#include <stdint.h>

#include "async_copy.cuh"
#include "attention_common.cuh"

namespace flux {
namespace split {

constexpr int kKeys = 64;  // keys of one tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;  // query rows of one CTA when G > 1

// The most tiles one split may hold, so that its scores and positions fit
// in shared memory beside the stages (decode_attention.py: MAX_SPLIT_TILES).
template <int kG> constexpr int max_tiles() { return kG == 1 ? 256 : 64; }

// Shared memory of one CTA, from a 128-byte aligned base: kStages slots of
// one K or V tile each, their mbarriers, q (kG, D) in fp32, the block
// reductions' partials, then the split's positions (tiles * 64) and its
// scores (kG, tiles * 64), fp32, which become the probabilities.
template <typename T, int D, int kG> struct Plan {
  static constexpr int kChunk = kKeys * D * (int)sizeof(T);
  static constexpr int kStages = 4 * kChunk <= 65536 ? 4 : 2;
  static constexpr int kE = 16 / (int)sizeof(T);  // elements of 16 bytes
  static constexpr int kVecs = D / kE;  // 16-byte vectors of a row
  static constexpr int kGroups = kThreads / kVecs;  // key groups of pass V
  static constexpr uint32_t kBars = kStages * kChunk;
  static constexpr uint32_t kQ = kBars + 8 * kStages;
  static constexpr uint32_t kRed = kQ + 4 * kG * D;
  static constexpr uint32_t kPos = kRed + 4 * kWarps * kG;
  static size_t bytes(int tiles) {
    return kPos + (size_t)4 * kKeys * tiles * (1 + kG);
  }
  static_assert(kVecs % 2 == 0 && kGroups * D * 4 <= kBars, "layout");
};

// 4 bytes from src to shared dst by cp.async.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// `bytes` contiguous bytes from src to shared dst by the TMA unit (a 1-D
// bulk copy), completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes of shared memory as fp32.
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Max (kMax) or sum of x[g] over the CTA; every thread gets the result.
template <bool kMax, int kG>
__device__ __forceinline__ void block_reduce(float (&x)[kG], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = kMax ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) red[warp * kG + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float r = red[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w * kG + g]) : r + red[w * kG + g];
    x[g] = r;
  }
  __syncthreads();  // red is read before it is written again
}

}  // namespace split
}  // namespace flux
