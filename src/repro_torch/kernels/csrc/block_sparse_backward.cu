// Attention backward (dq, dk, dv) of the block-sparse kernel, for Hopper
// (sm_90a): bf16 on the tensor cores (backward_wgmma.cuh), fp32 on the
// CUDA cores (backward_fp32.cuh).
//
// Replaces no TPU kernel. The JAX package trains xa (XAttention) through
// XLA's autodiff of `_block_topk` (src/repro/core/modes.py:473); the
// port's xa forward runs the hand-written block-sparse kernel
// (block_sparse_attention.cu), whose output PyTorch cannot differentiate,
// so its gradient is this kernel. It is the gradient of that kernel's
// plain version (kernels/ref.py `block_sparse_attention_ref`), with the
// conventions of attention_backward.cu: p rounded to V's dtype with the
// gradient passed straight through, the row max a constant, and a row
// with no visible key getting no gradient. Query row r (position q_offset
// + r) sees key c iff c <= q_offset + r, c < Skv, r < Sq and c's 64-key
// tile is in the selection of r's 64-row block.
//
// The selection is walked from both sides through lists the caller builds
// on the device (kernels/block_sparse_backward.py `walk_lists`: a sort,
// no atomics, nothing read back to the host): dq's CTA (query head, 64
// rows) walks its row block's live tiles ascending, as the forward
// compacts them; dk / dv's CTA (KV head, 64 keys) walks the inverse, the
// (query head of its group, query tile) pairs whose selection names its
// tile, in head then tile order. xa's top-k is per query head, so the G
// heads of a group may select different tiles; the CTA sums them in its
// dK / dV registers, as the flash and streaming gradient does. Both
// engines take the walk from SparsePolicy (backward_wgmma.cuh), so the
// kernels, their masks and their arithmetic are the flash and streaming
// gradient's: a tile wholly below the diagonal runs unmasked, the others
// under the mask.
//
// What bounds it: 2·(3·Dk + 2·Dv) operations per visible pair of the
// selection against the bytes of q, k, v, dO, dq, dk and dv read or
// written once; at xa's training shapes (4096 tokens, top-4 of 32 blocks
// of 128, D = 96) the operations. The bf16 engine runs 13-16 products of
// 2·D a pair (backward_wgmma.cuh says why), so its ceiling is 5/13 of the
// bound; a CTA whose list is short (a key tile few rows select) is
// mostly start-up.
#include "attention_common.cuh"
#include "backward_fp32.cuh"

namespace flux {
namespace bwd {

// The lists and the selection's shape: rows (BH, nqt, K) / counts (BH,
// nqt) for dq, offs (BHkv nkt + 1) / items for dk / dv.
struct SparseLists {
  const int* rows;
  const int* counts;
  const int* offs;
  const int* items;
  int nqt, nkt, K;
  template <int kSub> SparsePolicy<kSub> policy(int q_offset) const {
    return SparsePolicy<kSub>{q_offset, nqt, nkt, K, rows, counts, offs,
                              items};
  }
};

template <typename T, int Dk, int Dv> struct SparseBackwardLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk, void* dv,
                         float* stats, int BH, int BHkv, int Sq, int Skv,
                         SparseLists lists, int q_offset, float scale,
                         cudaStream_t stream) {
    constexpr int kSub = kBK / Tiles<Dk, Dv>::kStep;
    return launch<T, Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq,
                             Skv, scale, lists.policy<kSub>(q_offset),
                             stream);
  }
};

template <typename T, int Dk, int Dv> struct SparseBackwardWgmmaLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk, void* dv,
                         float* stats, int BH, int BHkv, int Sq, int Skv,
                         SparseLists lists, int q_offset, float scale,
                         cudaStream_t stream) {
    return wg::launch<Dk, Dv>(q, k, v, dout, dq, dk, dv, stats, BH, BHkv, Sq,
                              Skv, scale, lists.policy<1>(q_offset), stream);
  }
};

}  // namespace bwd
}  // namespace flux

// q, dout, dq (BH, Sq, Dk / Dv / Dk); k, v, dk, dv (BHkv, Skv, Dk / Dv /
// Dk / Dv); stats as attention_backward's; rows (BH, nqt, K) int32: each
// 64-row block's live 64-key tiles (< nkt, no repeat) ascending, then any
// values; counts (BH, nqt) int32: how many are live; offs (BHkv nkt + 1)
// int32 and items: key tile kt of KV head bkv is named by the entries
// items[offs[bkv nkt + kt] .. offs[bkv nkt + kt + 1]), g nqt + t each
// (query head bkv G + g, query tile t); nqt = ceil(Sq / 64), nkt =
// ceil(Skv / 64). All contiguous, q..dv of one dtype (0 = fp32, 1 = bf16;
// bf16 bases and stats 16-byte aligned), (Dk, Dv) with Dk = Dv a built
// head dim, or (192, 128). Returns a cudaError_t code.
extern "C" int block_sparse_backward(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     void* dq, void* dk, void* dv,
                                     void* stats, const void* rows,
                                     const void* counts, const void* offs,
                                     const void* items, int BH, int BHkv,
                                     int Sq, int Skv, int Dk, int Dv,
                                     int dtype, int K, int q_offset,
                                     float scale, void* stream) {
  const flux::bwd::SparseLists lists{
      static_cast<const int*>(rows), static_cast<const int*>(counts),
      static_cast<const int*>(offs), static_cast<const int*>(items),
      (Sq + flux::kBQ - 1) / flux::kBQ, (Skv + flux::kBK - 1) / flux::kBK,
      K};
  return flux::dispatch_pair_by_dtype<flux::bwd::SparseBackwardLaunch,
                                      flux::bwd::SparseBackwardWgmmaLaunch>(
      dtype, Dk, Dv, q, k, v, dout, dq, dk, dv, static_cast<float*>(stats),
      BH, BHkv, Sq, Skv, lists, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}
