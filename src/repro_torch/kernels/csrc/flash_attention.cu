// Causal / bidirectional flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bh, body _kernel). Same function: online softmax over
// key tiles, a runtime q_offset for the causal comparison, GQA through key
// row b / G (KV is never repeated), and key tiles wholly above the diagonal
// skipped, not masked.
//
// Two engines, chosen by the operands' dtype (never a retry on failure):
// bf16 runs on the tensor cores (prefill_wgmma.cuh: TMA loads into K and V
// slots, wgmma for QK^T and PV); fp32 runs PrefillBlock's fp32 FMAs on
// the CUDA cores (attention_common.cuh), since the tensor cores offer fp32
// products only as TF32. A bf16 CUDA operand goes to the wgmma engine or
// the call returns an error.
//
// What bounds it: at the serving route chunk (512 queries, head dim 96)
// the least time is set by the bytes of q, k, v and o; at long prompts the
// S^2 products make it bound by tensor-core operations. The design keeps
// the (S, S) scores out of device memory (each 64 x 64 score tile lives in
// registers), reads every key tile once per query block, drops the tiles
// above the diagonal, and in bf16 keeps the next tile's TMA load in flight
// under the current tile's products. At the route chunk 1024 CTAs walk 1
// to 8 tiles each, so each CTA's start (its Q and first K / V loads in
// flight before the first product) and the last wave weigh as much as the
// products.
#include "attention_common.cuh"
#include "prefill_wgmma.cuh"

namespace flux {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int G, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  PrefillBlock<T, D> blk;
  blk.init(smem);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  const T* kb = k + (size_t)(bh / G) * Skv * D;
  const T* vb = v + (size_t)(bh / G) * Skv * D;
  blk.load_q(q + (size_t)bh * Sq * D, row0, Sq);

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {
    // the largest live query position bounds the keys any row can see
    const int last_q = q_offset + min(row0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    blk.step(kb, vb, t * kBK, Skv, scale, [&](int r, int key) {
      return key < Skv && row0 + r < Sq &&
             (!causal || key <= q_offset + row0 + r);
    });
  }
  blk.store(o + (size_t)bh * Sq * D, row0, Sq);
}

template <typename T, int D> struct FlashLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         int BH, int BHkv, int Sq, int Skv, int causal,
                         int q_offset, float scale, cudaStream_t stream) {
    const size_t bytes = PrefillSmem<D>::kBytes;
    auto kernel = flash_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, BH / BHkv,
        causal, q_offset, scale);
    return cudaSuccess;
  }
};

template <int D>
__global__ void __launch_bounds__(wgmma::kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int Sq, int Skv, int G,
                   int causal, int q_offset, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  wgmma::Engine<D> eng;
  eng.init(wg_smem);
  __syncthreads();  // the mbarriers are initialised
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {
    const int last_q = q_offset + min(row0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }
  eng.run(&qmap, &kmap, &vmap, bh, bh / G, row0, n_tiles,
          [](int j) { return j; }, Skv, causal != 0, q_offset, scale_log2);
  eng.store(o + (size_t)bh * Sq * D, row0, Sq);
}

template <typename T, int D> struct FlashWgmmaLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         int BH, int BHkv, int Sq, int Skv, int causal,
                         int q_offset, float scale, cudaStream_t stream) {
    wgmma::Maps maps;
    cudaError_t e = maps.make(q, k, v, BH, BHkv, Sq, Skv, D);
    if (e != cudaSuccess) return e;
    const size_t bytes = wgmma::Layout<D>::bytes(0);
    auto kernel = flash_wgmma_kernel<D>;
    e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, wgmma::kThreads, bytes, stream>>>(
        maps.q, maps.k, maps.v, static_cast<__nv_bfloat16*>(o), Sq, Skv,
        BH / BHkv, causal, q_offset, scale * kLog2e);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, Sq, D), k / v (BHkv, Skv, D), o (BH, Sq, D); all contiguous and of
// one dtype (0 = fp32, 1 = bf16; bf16 bases 16-byte aligned). Returns a
// cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BH, int BHkv,
                                   int Sq, int Skv, int D, int dtype,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  return flux::dispatch_by_dtype<flux::FlashLaunch, flux::FlashWgmmaLaunch>(
      dtype, D, q, k, v, o, BH, BHkv, Sq, Skv, causal, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}
