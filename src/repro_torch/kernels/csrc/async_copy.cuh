// Shared-memory addresses, mbarriers and the SFU's exp2 for Hopper
// (sm_90a): what the wgmma prefill engine (prefill_wgmma.cuh) and the
// split decode kernel (decode_attention.cu) both use to wait on their
// asynchronous loads and to compute the softmax in log2 units.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flux {

constexpr float kLog2e = 1.4426950408889634f;
// polls of an mbarrier before the kernel traps: a load that never lands
// (a fault in a kernel) ends the launch with an error instead of hanging
constexpr uint32_t kSpinLimit = 1u << 24;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();
  }
}

// 2^x on the SFU (ex2.approx.ftz: results below 2^-126 flush to 0, far
// below what a bf16 p or the fp32 sum l can hold next to the row's max).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flux
