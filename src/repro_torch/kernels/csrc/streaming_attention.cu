// Streaming (sink + local) attention, the SSA prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/streaming_attention.py
// (streaming_attention_bh, body _kernel, window start _win_start_block).
// Same function: query position p sees key c iff c <= p and (c < sink or
// p - c < local). Each query block visits the sink tiles, then the tiles
// of its window, so the work is O(S * (sink + local)) and not O(S^2). Sink
// keys belong to the sink pass only and window keys to the window pass
// only, so no key is counted twice; the window pass starts at the first
// tile holding a key >= sink and never revisits a tile.
//
// What bounds it: at the serving route chunk (512 queries, the window
// covers the whole chunk) the bytes of q, k, v and o; at prompts much
// longer than sink + local, tensor-core operations over the window. Like
// the flash kernel it does its products as fp32 FMAs on the CUDA cores,
// keeps every score tile on chip, and reads each visited key tile once per
// query block.
#include "attention_common.cuh"

namespace flux {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
streaming_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int G, int sink, int local, int q_offset, float scale) {
  extern __shared__ float smem[];
  PrefillBlock<T, D> blk;
  blk.init(smem);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  const T* kb = k + (size_t)(bh / G) * Skv * D;
  const T* vb = v + (size_t)(bh / G) * Skv * D;
  blk.load_q(q + (size_t)bh * Sq * D, row0, Sq);

  const int first_q = q_offset + row0;
  const int last_q = q_offset + min(row0 + kBQ, Sq) - 1;
  const int n_tiles = (Skv + kBK - 1) / kBK;
  const int last_tile = min(n_tiles - 1, last_q / kBK);  // causal bound

  // sink pass: keys [0, sink)
  const int n_sink = min((sink + kBK - 1) / kBK, last_tile + 1);
  for (int t = 0; t < n_sink; ++t) {
    blk.step(kb, vb, t * kBK, Skv, scale, [&](int r, int key) {
      return key < sink && key < Skv && row0 + r < Sq &&
             key <= q_offset + row0 + r;
    });
  }
  // window pass: keys >= sink within `local` of the query
  const int w0 = max(floor_div(first_q - (local - 1), kBK), sink / kBK);
  for (int t = max(w0, 0); t <= last_tile; ++t) {
    blk.step(kb, vb, t * kBK, Skv, scale, [&](int r, int key) {
      const int p = q_offset + row0 + r;
      return key >= sink && p - key < local && key <= p && key < Skv &&
             row0 + r < Sq;
    });
  }
  blk.store(o + (size_t)bh * Sq * D, row0, Sq);
}

template <typename T, int D> struct StreamingLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         int BH, int BHkv, int Sq, int Skv, int sink,
                         int local, int q_offset, float scale,
                         cudaStream_t stream) {
    const size_t bytes = PrefillSmem<D>::kBytes;
    auto kernel = streaming_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, BH / BHkv,
        sink, local, q_offset, scale);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, Sq, D), k / v (BHkv, Skv, D), o (BH, Sq, D); sink >= 0 and
// local >= 1 in tokens. Returns a cudaError_t code.
extern "C" int streaming_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int BH,
                                       int BHkv, int Sq, int Skv, int D,
                                       int dtype, int sink, int local,
                                       int q_offset, float scale,
                                       void* stream) {
  return flux::dispatch<flux::StreamingLaunch>(
      dtype, D, q, k, v, o, BH, BHkv, Sq, Skv, sink, local, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}
