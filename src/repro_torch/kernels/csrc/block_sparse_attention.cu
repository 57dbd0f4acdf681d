// Block-sparse attention over a per-query-block list of key tiles, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/block_sparse_attention.py (block_sparse_attention_bh,
// body _kernel). Same function: sel (BH, nqb, K) int32 names, for each
// 64-row query block, the 64-key tiles it attends to; -1 entries are
// skipped (no load, no products). Duplicates are the caller's to remove.
// The causal shift q_offset is a runtime argument, so one build serves
// every chunk start: query row r sees key c iff c <= q_offset + r, c < Skv
// and r < Sq. The serving path feeds it the causal selection of a streamed
// prompt chunk over the full KV cache (modes.chunk_causal_attention).
//
// Two engines, chosen by the operands' dtype (never a retry on failure):
// bf16 runs on the tensor cores (prefill_wgmma.cuh); fp32 runs
// PrefillBlock's fp32 FMAs on the CUDA cores (attention_common.cuh), since
// the tensor cores offer fp32 products only as TF32. A bf16 CUDA operand
// goes to the wgmma engine or the call returns an error.
//
// What bounds it: on the main path a 512-query chunk attends a prefix of
// up to a few thousand keys (at 3584 over a 4128-slot cache, 96.6 GFLOP of
// QK^T and PV), so the least time is set by tensor-core operations; the
// bytes of the prefix are read once per query block, and the 8 query
// blocks of one head read the same tiles close together in time, so most
// of those reads hit L2. The bf16 design puts both products on wgmma,
// compacts its selection row into shared memory first (the TPU kernel's
// scalar prefetch; a -1 costs neither a load nor a bubble) and keeps the
// next live tile's TMA load in flight under the current tile's products.
// What holds it above the bound: each tile is a serial chain per
// warpgroup (S, the softmax on the CUDA cores, P V), overlapped only with
// the chains of the other CTAs on the SM, and every query block moves its
// prefix from L2 to shared memory again.
//
// Values may be narrower than queries and keys, as in flash_attention.cu:
// MLA's route chunk under xa runs at (Dk, Dv) = (192, 128).
#include "attention_common.cuh"
#include "prefill_wgmma.cuh"

namespace flux {

template <typename T, int D, int Dv>
__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ sel,
                    T* __restrict__ o, int Sq, int Skv, int G, int n_sel,
                    int q_offset, float scale) {
  extern __shared__ float smem[];
  PrefillBlock<T, D, Dv> blk;
  blk.init(smem);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  const T* kb = k + (size_t)(bh / G) * Skv * D;
  const T* vb = v + (size_t)(bh / G) * Skv * Dv;
  const int* row_sel = sel + ((size_t)bh * gridDim.x + blockIdx.x) * n_sel;
  blk.load_q(q + (size_t)bh * Sq * D, row0, Sq);

  for (int j = 0; j < n_sel; ++j) {
    const int tile = row_sel[j];  // the same address for every thread
    if (tile < 0) continue;
    blk.step(kb, vb, tile * kBK, Skv, scale, [&](int r, int key) {
      return key <= q_offset + row0 + r && key < Skv && row0 + r < Sq;
    });
  }
  blk.store(o + (size_t)bh * Sq * Dv, row0, Sq);
}

template <typename T, int D, int Dv> struct BlockSparseLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* sel, void* o, int BH, int BHkv, int Sq,
                         int Skv, int n_sel, int q_offset, float scale,
                         cudaStream_t stream) {
    const size_t bytes = PrefillSmem<D, Dv>::kBytes;
    auto kernel = block_sparse_kernel<T, D, Dv>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(sel),
        static_cast<T*>(o), Sq, Skv, BH / BHkv, n_sel, q_offset, scale);
    return cudaSuccess;
  }
};

template <int D, int Dv>
__global__ void __launch_bounds__(wgmma::kThreads)
block_sparse_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const int* __restrict__ sel,
                          __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                          int G, int n_sel, int q_offset, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  wgmma::Engine<D, Dv> eng;
  eng.init(wg_smem);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  const int n_live = eng.compact(
      sel + ((size_t)bh * gridDim.x + blockIdx.x) * n_sel, n_sel);
  const int* live = eng.list;
  eng.run(&qmap, &kmap, &vmap, bh, bh / G, row0, n_live,
          [live](int j) { return live[j]; }, Skv, true, q_offset,
          scale_log2);
  eng.store(o + (size_t)bh * Sq * Dv, row0, Sq);
}

template <typename T, int D, int Dv> struct BlockSparseWgmmaLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* sel, void* o, int BH, int BHkv, int Sq,
                         int Skv, int n_sel, int q_offset, float scale,
                         cudaStream_t stream) {
    wgmma::Maps maps;
    cudaError_t e = maps.make(q, k, v, BH, BHkv, Sq, Skv, D, Dv);
    if (e != cudaSuccess) return e;
    const size_t bytes = wgmma::Layout<D, Dv>::bytes(n_sel);
    auto kernel = block_sparse_wgmma_kernel<D, Dv>;
    e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, wgmma::kThreads, bytes, stream>>>(
        maps.q, maps.k, maps.v, static_cast<const int*>(sel),
        static_cast<__nv_bfloat16*>(o), Sq, Skv, BH / BHkv, n_sel, q_offset,
        scale * kLog2e);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, Sq, D), k (BHkv, Skv, D), v (BHkv, Skv, Dv), sel (BH,
// ceil(Sq / 64), n_sel) int32 tile indices (-1 = skip), o (BH, Sq, Dv);
// (D, Dv) with D = Dv a built head dim, or (192, 128); bf16 bases 16-byte
// aligned. Returns a cudaError_t.
extern "C" int block_sparse_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* sel,
                                          void* o, int BH, int BHkv, int Sq,
                                          int Skv, int D, int dtype,
                                          int n_sel, int q_offset,
                                          float scale, int Dv, void* stream) {
  return flux::dispatch_pair_by_dtype<flux::BlockSparseLaunch,
                                      flux::BlockSparseWgmmaLaunch>(
      dtype, D, Dv, q, k, v, sel, o, BH, BHkv, Sq, Skv, n_sel, q_offset,
      scale, static_cast<cudaStream_t>(stream));
}
