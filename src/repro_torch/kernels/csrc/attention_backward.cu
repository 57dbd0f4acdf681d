// Attention backward (dq, dk, dv) of the flash and streaming kernels, for
// Hopper (sm_90a): bf16 on the tensor cores (backward_wgmma.cuh), fp32 on
// the CUDA cores (backward_fp32.cuh).
//
// Replaces no TPU kernel. The JAX package trains through XLA's autodiff of
// its blocked `modes.attention` (src/repro/core/modes.py:120); the port's
// training forward runs the hand-written flash and streaming kernels, whose
// outputs PyTorch cannot differentiate, so their gradient is this kernel.
// It computes the gradient of the kernels' plain versions (kernels/ref.py):
// o_i = sum_j round(p_ij) v_j / l_i with p_ij = exp(s_ij - m_i), s = scale *
// q k^T under the mask, l_i = sum_j p_ij, the rounding of p to v's dtype
// passing the gradient straight through. With P = p / l and D_i = dO_i . O_i:
//   dV_j = sum_i round(p_ij) / l_i dO_i,  dP_ij = dO_i . v_j,
//   dS_ij = P_ij (dP_ij - D_i),  dQ_i = scale sum_j dS_ij k_j,
//   dK_j = scale sum_i dS_ij q_i.
// One mask policy per kind: causal or bidirectional with q_offset (flash),
// sink + local with q_offset (streaming; a sliding window at sink 0).
//
// Two engines, chosen by the operands' dtype (never a retry on failure).
// bf16 operands run wg::launch (backward_wgmma.cuh): TMA loads and wgmma
// products, 13-16 products of 2·D a visible pair against the 5 that bound
// it (its note says why). fp32 operands run the two kernels of
// backward_fp32.cuh on the CUDA cores, since the tensor cores offer fp32
// products only as TF32; they are what the card is held to the CPU with in
// training (chip_smoke phase 29). A streaming query tile walks the sink
// tiles [0, n_sink), then the window tiles from max(w0, n_sink): the tile
// that straddles `sink` is walked once, under the whole mask (the forward
// walks it twice under disjoint masks). The mask policies and their walks
// are backward_wgmma.cuh's.
//
// (Dk, Dv): Dk = Dv at every built head dim, and (192, 128), MLA's route
// chunk (queries and keys of nope + rope = 192 columns over values of
// 128): S and dQ reduce over Dk, dP over Dv, dK is Dk wide and dV Dv.
// The bf16 engine's dk / dv CTA splits them on two warpgroups there (dK
// m64n192k16 on the first, dV m64n128k16 on the second).
//
// What bounds it: 2·(3·Dk + 2·Dv) operations per visible (query, key)
// pair (S, dQ, dK over Dk; dP, dV over Dv) against the bytes of q, k, v,
// dO, dq, dk and dv; at training shapes (4096 tokens, D = 96) the
// operations, by far.
#include "attention_common.cuh"
#include "backward_fp32.cuh"

namespace flux {
namespace bwd {

template <typename T, int Dk, int Dv> struct BackwardLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk,
                         void* dv, float* stats, int BH, int BHkv, int Sq,
                         int Skv, int kind, int causal, int sink, int local,
                         int q_offset, float scale, cudaStream_t stream) {
    if (kind == 0)
      return launch<T, Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv,
                               Sq, Skv, scale, FlashPolicy{causal, q_offset},
                               stream);
    return launch<T, Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq,
                             Skv, scale,
                             StreamingPolicy{sink, local, q_offset}, stream);
  }
};

// bf16: the tensor-core engine (wg::launch; stats (3, BH, Sq rounded up
// to 64)).
template <typename T, int Dk, int Dv> struct BackwardWgmmaLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk,
                         void* dv, float* stats, int BH, int BHkv, int Sq,
                         int Skv, int kind, int causal, int sink, int local,
                         int q_offset, float scale, cudaStream_t stream) {
    if (kind == 0)
      return wg::launch<Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv,
                                Sq, Skv, scale, FlashPolicy{causal, q_offset},
                                stream);
    return wg::launch<Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq,
                              Skv, scale,
                              StreamingPolicy{sink, local, q_offset}, stream);
  }
};

// flux_backward_smem_bytes' answer for the (Dk, Dv) pairs dispatch_head_dims
// builds.
template <typename T, int Dk, int Dv> struct BackwardSmem {
  static cudaError_t run(int* bytes) {
    *bytes = (int)wg::Layout<Dk, Dv>::kBytes;
    return cudaSuccess;
  }
};

}  // namespace bwd
}  // namespace flux

// q, dout, dq (BH, Sq, D / Dv / D); k, v, dk, dv (BHkv, Skv, D / Dv / D /
// Dv); stats float32 scratch of 3 x BH x Sq_pad floats, Sq_pad = Sq
// rounded up to 64 (the rows' m, l and D: the fp32 kernels use it as (3,
// BH, Sq), the bf16 engine as (3, BH, Sq_pad) with 1 / l); all contiguous,
// q..dv of one dtype (0 = fp32, 1 = bf16; bf16 bases and stats 16-byte
// aligned, for TMA), (D, Dv) with D = Dv a built head dim, or (192, 128).
// kind 0: flash (`causal`, `q_offset`); kind 1: streaming (`sink` >= 0,
// `local` >= 1, `q_offset`). Returns a cudaError_t code.
extern "C" int attention_backward(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  void* dq, void* dk,
                                  void* dv, void* stats, int BH, int BHkv,
                                  int Sq, int Skv, int D, int dtype, int kind,
                                  int causal, int sink, int local,
                                  int q_offset, float scale, int Dv,
                                  void* stream) {
  return flux::dispatch_pair_by_dtype<flux::bwd::BackwardLaunch,
                                      flux::bwd::BackwardWgmmaLaunch>(
      dtype, D, Dv, q, k, v, dout, dq, dk, dv, static_cast<float*>(stats),
      BH, BHkv, Sq, Skv, kind, causal, sink, local, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one CTA of the bf16 engine asks for at head dims
// (Dk, Dv); -1 for a pair not built.
extern "C" int flux_backward_smem_bytes(int Dk, int Dv) {
  int bytes = -1;
  flux::dispatch_head_dims<flux::bwd::BackwardSmem, __nv_bfloat16>(Dk, Dv,
                                                                   &bytes);
  return bytes;
}
