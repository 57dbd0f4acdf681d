// Streaming (sink + local) attention, the SSA prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/streaming_attention.py
// (streaming_attention_bh, body _kernel, window start _win_start_block).
// Same function: query position p sees key c iff c <= p and (c < sink or
// p - c < local). Each query block visits the sink tiles, then the tiles
// of its window, so the work is O(S * (sink + local)) and not O(S^2). Sink
// keys belong to the sink pass only and window keys to the window pass
// only, so no key is counted twice; the window pass starts at the first
// tile holding a key >= sink and never revisits a tile. A tile that
// straddles `sink` is walked in both passes, with disjoint masks.
//
// Two engines, chosen by the operands' dtype (never a retry on failure):
// bf16 runs on the tensor cores (prefill_wgmma.cuh: TMA loads into K and V
// slots, wgmma for QK^T and PV, under its StreamingMask policy); fp32 runs
// PrefillBlock's fp32 FMAs on the CUDA cores (attention_common.cuh), since
// the tensor cores offer fp32 products only as TF32.
//
// What bounds it: at the serving route chunk (512 queries, sink 128, local
// 2048 >= 512) the mask is exactly causal, so the work is flash's and the
// least time is set by the bytes of q, k, v and o; at prompts much longer
// than sink + local, by tensor-core operations over sink + window. The
// design keeps every score tile in registers, reads each visited key tile
// once per query block, and masks only the tiles that cross Skv, the
// diagonal, the sink boundary or some row's window edge.

#include "attention_common.cuh"
#include "prefill_wgmma.cuh"

namespace flux {

template <typename T, int D, int Dv>
__global__ void __launch_bounds__(kThreads)
streaming_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int G, int sink, int local, int q_offset, float scale) {
  extern __shared__ float smem[];
  PrefillBlock<T, D, Dv> blk;
  blk.init(smem);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  const T* kb = k + (size_t)(bh / G) * Skv * D;
  const T* vb = v + (size_t)(bh / G) * Skv * Dv;
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
  blk.store(o + (size_t)bh * Sq * Dv, row0, Sq);
}

template <typename T, int D, int Dv> struct StreamingLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         int BH, int BHkv, int Sq, int Skv, int sink,
                         int local, int q_offset, float scale,
                         cudaStream_t stream) {
    const size_t bytes = PrefillSmem<D, Dv>::kBytes;
    auto kernel = streaming_kernel<T, D, Dv>;
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

template <int D, int Dv>
__global__ void __launch_bounds__(wgmma::kThreads)
streaming_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int Sq, int Skv, int G,
                       int sink, int local, int q_offset, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  wgmma::Engine<D, Dv> eng;
  eng.init(wg_smem);
  __syncthreads();  // the mbarriers are initialised
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBQ;
  // the walk of streaming_kernel: sink tiles [0, n_sink), then the window
  // tiles [w0, last_tile]
  const int first_q = q_offset + row0;
  const int last_q = q_offset + min(row0 + kBQ, Sq) - 1;
  const int n_tiles = (Skv + kBK - 1) / kBK;
  const int last_tile = min(n_tiles - 1, last_q / kBK);
  const int n_sink = min((sink + kBK - 1) / kBK, last_tile + 1);
  const int w0 =
      max(max(floor_div(first_q - (local - 1), kBK), sink / kBK), 0);
  const int n_walk = n_sink + max(last_tile - w0 + 1, 0);
  eng.run(&qmap, &kmap, &vmap, bh, bh / G, row0, n_walk,
          [n_sink, w0](int j) { return j < n_sink ? j : w0 + (j - n_sink); },
          Skv, true, q_offset, scale_log2,
          wgmma::StreamingMask{sink, local, n_sink, last_q});
  eng.store(o + (size_t)bh * Sq * Dv, row0, Sq);
}

template <typename T, int D, int Dv> struct StreamingWgmmaLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v, void* o,
                         int BH, int BHkv, int Sq, int Skv, int sink,
                         int local, int q_offset, float scale,
                         cudaStream_t stream) {
    wgmma::Maps maps;
    cudaError_t e = maps.make(q, k, v, BH, BHkv, Sq, Skv, D, Dv);
    if (e != cudaSuccess) return e;
    const size_t bytes = wgmma::Layout<D, Dv>::bytes(0);
    auto kernel = streaming_wgmma_kernel<D, Dv>;
    e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kernel<<<grid, wgmma::kThreads, bytes, stream>>>(
        maps.q, maps.k, maps.v, static_cast<__nv_bfloat16*>(o), Sq, Skv,
        BH / BHkv, sink, local, q_offset, scale * kLog2e);
    return cudaSuccess;
  }
};

}  // namespace flux

// q (BH, Sq, D), k (BHkv, Skv, D), v (BHkv, Skv, Dv), o (BH, Sq, Dv); all
// contiguous and of one dtype (0 = fp32, 1 = bf16; bf16 bases 16-byte
// aligned); (D, Dv) as flash_attention_fwd takes them; sink >= 0 and
// local >= 1 in tokens. Returns a cudaError_t code.
extern "C" int streaming_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int BH,
                                       int BHkv, int Sq, int Skv, int D,
                                       int Dv, int dtype, int sink,
                                       int local, int q_offset, float scale,
                                       void* stream) {
  return flux::dispatch_pair_by_dtype<flux::StreamingLaunch,
                                      flux::StreamingWgmmaLaunch>(
      dtype, D, Dv, q, k, v, o, BH, BHkv, Sq, Skv, sink, local, q_offset,
      scale, static_cast<cudaStream_t>(stream));
}
