// Tensor-core attention backward (dq, dk, dv) for bf16 operands on Hopper
// (sm_90a), and the mask policies and tile walks it shares with the fp32
// kernels of attention_backward.cu.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// its blocked `modes.attention` (src/repro/core/modes.py:120); this is the
// gradient of the port's flash and streaming kernels. It computes what the
// fp32 kernels compute (attention_backward.cu: the gradient of
// kernels/ref.py `_masked_attention`, p rounded to V's dtype with the
// gradient passed straight through, the row max a constant, and
// D_i = sum_j round(p_ij) / l_i dP_ij formed from the kernel's own rounded
// p). The A operands of the last products, round(p) / l and dS, enter as
// two bf16 parts each, hi = bf16(x) and lo = bf16(x - hi), in two wgmmas:
// their sum carries x to about 2^-17 of itself. One part (2^-9) put dq, dk
// and dv 1.1-2.6 times past the bf16 limit at 4096 tokens: a causal mask's
// first rows have |dS| near 10 while the gradients' rms falls with the
// length. kernels/ref.py `attention_backward_tiled_ref` repeats this
// arithmetic step by step.
//
// What bounds it: 5 products of 2·D operations per visible (query, key)
// pair (S, dP, dV, dK, dQ) against the bytes of q, k, v, dO, dq, dk and
// dv; at training shapes (4096 tokens, D = 96) the operations, by far, at
// the tensor cores' bf16 rate. This design runs 13 (dq: S three times, dP
// twice and dQ in two parts; dkdv: S, dP, and dV and dK in two parts
// each), so its ceiling is 5 / 13 of the bound; 14 from D = 128, where
// dkdv's second warpgroup recomputes S^T, and 16 at D = 256, where dq's
// third pass runs twice. The forward kernels write neither the rows' max
// m nor their sum l, and recomputing them here costs the first of dq's
// three passes; the two-part operands cost three. Every product is a
// wgmma on tiles that TMA brought into shared memory, the scores never
// leave registers, and the next tiles' loads are in flight under the
// current tile's products.
//
// 1. dq_wgmma_kernel: one CTA of one warpgroup per (query head, 64 query
//    rows). Q and dO are loaded once; K and V tiles come through a ring of
//    kStages slots, each completing on one mbarrier. The walk runs three
//    passes over the row block's key tiles (Policy::key_tiles):
//    pass 1, S = Q K^T (m64n64k16, both K-major), gives m and l;
//    pass 2, S and dP = dO V^T, gives D_i;
//    pass 3, S, dP, then dS = P (dP - D_i) in fp32 registers, split into
//    two bf16 parts as the A fragments of dQ += dS K (RS: K read MN-major
//    from the slot that was K-major for S). dP - D_i is formed before any
//    rounding, so a row whose gradient cancels (the first row of a causal
//    mask, where dP - D_i = 0 exactly) keeps it. The rows' m (log2 units),
//    1 / l and D_i go to `stats` for the second kernel. At Dk = 256 pass 3
//    runs twice, over dQ's first and last 128 columns (DqShape): the whole
//    accumulator beside S, dP and dS's parts passes 255 registers.
// 2. dkdv_wgmma_kernel: one CTA per (KV head, 64 keys). K and V are loaded
//    once; Q, dO and the rows' stats (three 256-byte bulk copies) come
//    through the ring, for each of the G query heads in turn, over the
//    query tiles that see the CTA's keys (Policy::query_tiles). The
//    products run transposed: S^T = K Q^T and dP^T = V dO^T (SS), whose
//    accumulators are, once split, the A fragments of dV += round(P^T)/l
//    dO and dK += dS^T Q (RS, dO and Q MN-major): neither P nor dS makes a
//    trip through shared memory. The G heads sum in the dK / dV registers:
//    deterministic, no atomics. Below Dk + Dv = 256 one warpgroup holds
//    dK, dV, S^T and dP^T; from it on (D = 128, 160, 256) two warpgroups
//    split the gradients, dK on the first (S^T, dP^T, dK) and dV on the
//    second (S^T, dV), so each holds one D-wide accumulator and dP^T runs
//    once.
//
// Masks. A tile whose pairs are all visible (Policy::full) and that lies
// inside Sq and Skv runs with no mask. The others mask every pair by the
// policy, and keys at or past Skv; dkdv also masks query rows at or past
// Sq explicitly (TMA's zero rows give s = 0, not -inf); dq writes those
// rows' stats as zeros, since dkdv's masked p = 0 still multiplies their
// 1 / l and D. A hidden pair's p is 0, so a row with no visible key
// gives no gradient, as in the fp32 kernels. The streaming tile that
// straddles `sink` is walked once, under the whole mask.
#pragma once

#include "prefill_wgmma.cuh"

namespace flux {
namespace bwd {

// A policy gives the mask (visible, full) and both walks. A row block
// (query head bh, rows from r0) walks `step`-key tiles: key_tiles sets
// its count a1 + max(b1 - b0, 0), and its step w is tile key_step(bh,
// r0, w, a1, b0). A key block (KV head bkv, keys from c0) walks the
// `step`-row query tiles [t0, t1) of query_tiles: a range policy (kLists
// false: flash, streaming) for each of the G heads in turn; a list
// policy (SparsePolicy) once, step j being query head step_head(..) and
// query tile step_tile(..).

// Causal or bidirectional, query row r at position q_offset + r.
struct FlashPolicy {
  static constexpr bool kLists = false;  // walks ranges
  int causal, q_offset;
  __device__ bool visible(int r, int key) const {
    return !causal || key <= q_offset + r;
  }
  // every pair of rows [r0, r1] x keys [k0, k1] visible
  __device__ bool full(int r0, int, int, int k1) const {
    return !causal || k1 <= q_offset + r0;
  }
  // key tiles of `step` keys seen by rows [r0, r1]: [0, a1) and [b0, b1)
  __device__ void key_tiles(int, int r0, int r1, int Skv, int step, int& a1,
                            int& b0, int& b1) const {
    int n = (Skv + step - 1) / step;
    if (causal) n = min(n, (q_offset + r1) / step + 1);
    a1 = n;
    b0 = b1 = 0;
  }
  // query tiles of `step` rows that see a key of [c0, c1]: [t0, t1)
  __device__ void query_tiles(int, int c0, int c1, int Sq, int step, int& t0,
                              int& t1) const {
    t1 = (Sq + step - 1) / step;
    t0 = causal ? max(c0 - q_offset, 0) / step : 0;
  }
  __device__ int key_step(int, int, int w, int a1, int b0) const {
    return w < a1 ? w : b0 + (w - a1);
  }
};

// Sink + local: position p sees key c iff c <= p and (c < sink or
// p - c < local).
struct StreamingPolicy {
  static constexpr bool kLists = false;
  int sink, local, q_offset;
  __device__ bool visible(int r, int key) const {
    const int p = q_offset + r;
    return key <= p && (key < sink || p - key < local);
  }
  __device__ bool full(int r0, int r1, int k0, int k1) const {
    return k1 <= q_offset + r0 &&
           (k1 < sink || q_offset + r1 - k0 < local);
  }
  __device__ void key_tiles(int, int r0, int r1, int Skv, int step, int& a1,
                            int& b0, int& b1) const {
    const int n = (Skv + step - 1) / step;
    const int last = min(n - 1, (q_offset + r1) / step);  // causal bound
    a1 = min((sink + step - 1) / step, last + 1);
    const int w0 = max(floor_div(q_offset + r0 - (local - 1), step), 0);
    b0 = max(w0, a1);
    b1 = last + 1;
  }
  __device__ void query_tiles(int, int c0, int c1, int Sq, int step, int& t0,
                              int& t1) const {
    t0 = max(c0 - q_offset, 0) / step;
    t1 = (Sq + step - 1) / step;
    if (c0 >= sink) {  // window keys only: rows up to c1 + local - 1
      const int hi = c1 + local - 1 - q_offset;
      t1 = hi < 0 ? 0 : min(t1, hi / step + 1);
    }
  }
  __device__ int key_step(int, int, int w, int a1, int b0) const {
    return w < a1 ? w : b0 + (w - a1);
  }
};

// Block-sparse (the gradient of block_sparse_attention.cu): query row r
// sees key c iff c <= q_offset + r and c's 64-key tile is in its 64-row
// block's selection. The walks are lists the caller builds on the device
// (kernels/block_sparse_backward.py `walk_lists`): `rows` (BH, nqt, K),
// each row block's live tiles ascending, `counts` (BH, nqt) of them; and
// for key tile kt of KV head bkv the entries items[offs[bkv nkt + kt]
// .. offs[bkv nkt + kt + 1]), g nqt + t for each (query head g of the
// group, query tile t) whose selection names kt, in that order. kSub =
// 64 / step: the fp32 kernels' 32-key and 32-row steps (Dk + Dv > 320)
// walk each 64-wide tile as kSub steps.
template <int kSub> struct SparsePolicy {
  static constexpr bool kLists = true;
  int q_offset, nqt, nkt, K;
  const int* rows;
  const int* counts;
  const int* offs;
  const int* items;
  __device__ bool visible(int r, int key) const { return key <= q_offset + r; }
  __device__ bool full(int r0, int, int, int k1) const {
    return k1 <= q_offset + r0;
  }
  __device__ void key_tiles(int bh, int r0, int, int, int, int& a1, int& b0,
                            int& b1) const {
    a1 = counts[(size_t)bh * nqt + r0 / kBQ] * kSub;
    b0 = b1 = 0;
  }
  __device__ void query_tiles(int bkv, int c0, int, int, int, int& t0,
                              int& t1) const {
    const int* o = offs + (size_t)bkv * nkt + c0 / kBK;
    t0 = 0;
    t1 = (o[1] - o[0]) * kSub;
  }
  __device__ int key_step(int bh, int r0, int w, int, int) const {
    return rows[((size_t)bh * nqt + r0 / kBQ) * K + w / kSub] * kSub +
           w % kSub;
  }
  // step j of key block (bkv, keys from c0): its list entry's query head
  // and `step`-row query tile
  __device__ int entry(int bkv, int c0, int j) const {
    return items[offs[(size_t)bkv * nkt + c0 / kBK] + j / kSub];
  }
  __device__ int step_head(int bkv, int c0, int j, int G) const {
    return bkv * G + entry(bkv, c0, j) / nqt;
  }
  __device__ int step_tile(int bkv, int c0, int j) const {
    return entry(bkv, c0, j) % nqt * kSub + j % kSub;
  }
};

namespace wg {

using wgmma::fence_regs;
using wgmma::kPanelBytes;
using wgmma::kPanelCols;
using wgmma::mnmajor_desc;
using wgmma::pack_bf16;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_pv;
using wgmma::wgmma_wait_all;

constexpr int kStages = 2;
// a row block's stats in dkdv's ring: m, 1 / l and D of 64 rows
constexpr uint32_t kPlaneBytes = kBQ * sizeof(float);
constexpr uint32_t kStatsBytes = 3 * kPlaneBytes;

// Byte offsets inside a CTA's shared memory, from a 1024-byte aligned
// base, as wgmma::Layout's 64-byte-swizzled panels: two resident tiles (A:
// Q in dq, K in dkdv, Dk wide; B: dO / V, Dv wide), a ring of kStages X
// tiles (K / Q, Dk wide) and Y tiles (V / dO, Dv wide), dkdv's stats ring,
// and the mbarriers (the resident tiles', then one per ring slot). 192 KB
// of tiles at D = 256, within the 227 KB a CTA of an H100 can use.
template <int Dk, int Dv> struct Layout {
  using Panels = wgmma::Layout<Dk, Dv>;
  static constexpr uint32_t kTileK = Panels::kTile;
  static constexpr uint32_t kTileV = Panels::kVTile;
  static constexpr uint32_t kA = 0;
  static constexpr uint32_t kB = kA + kTileK;
  static constexpr uint32_t kX = kB + kTileV;
  static constexpr uint32_t kY = kX + kStages * kTileK;
  static constexpr uint32_t kStats = kY + kStages * kTileV;
  static constexpr uint32_t kBars = kStats + kStages * kStatsBytes;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + kStages);
  static_assert(kBytes <= 232448, "one CTA's shared memory on an H100");
};

// dkdv's warpgroups: one, or from Dk + Dv = 256 on two (dK on the first,
// dV on the second): one warpgroup's dK and dV accumulators (Dk / 2 + Dv
// / 2 fp32 registers a thread) beside S^T, dP^T (64) and their two-part
// A fragments spilled at D = 128.
template <int Dk, int Dv> struct DkdvShape {
  static constexpr bool kTwo = Dk + Dv >= 256;
  static constexpr int kThreads = (kTwo ? 2 : 1) * wgmma::kThreads;
};

// dq's third pass runs kParts times, each over dQ's next Dk / kParts
// columns: at Dk = 256 the whole accumulator (128 registers) beside S, dP
// and dS's two parts passes 255.
template <int Dk> struct DqShape {
  static constexpr int kParts = Dk > 160 ? 2 : 1;
  static constexpr int kCols = Dk / kParts;
};

// The shared memory of one CTA: the ring's slots and barriers.
template <int Dk, int Dv> struct Ring {
  using L = Layout<Dk, Dv>;
  uint32_t base;   // shared address of the aligned base
  uint8_t* gbase;  // its generic address (the stats' loads)

  __device__ void init(uint8_t* smem) {
    const uint32_t raw = smem_u32(smem);
    const uint32_t pad = (1024 - (raw & 1023)) & 1023;
    base = raw + pad;
    gbase = smem + pad;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // barrier 0 is the resident tiles', 1 + s ring slot s's
  __device__ uint32_t bar(int i) const { return base + L::kBars + 8 * i; }
  __device__ uint32_t a() const { return base + L::kA; }
  __device__ uint32_t b() const { return base + L::kB; }
  __device__ uint32_t x(int j) const {
    return base + L::kX + (j % kStages) * L::kTileK;
  }
  __device__ uint32_t y(int j) const {
    return base + L::kY + (j % kStages) * L::kTileV;
  }
  __device__ uint32_t stats(int j) const {
    return base + L::kStats + (j % kStages) * kStatsBytes;
  }
  __device__ const float* stats_ptr(int j) const {
    return reinterpret_cast<const float*>(gbase + L::kStats +
                                          (j % kStages) * kStatsBytes);
  }
  // waits for step j's slot: its (j / kStages)-th completion
  __device__ void wait(int j) const {
    mbar_wait(bar(1 + j % kStages), (j / kStages) & 1);
  }
};

// Rows [row0, row0 + 64) of a (rows, seq, kP panels) map's row `head` into
// the tile at dst, one TMA box per panel, completing on bar (whose
// expected bytes the caller set).
template <int kP>
__device__ __forceinline__ void load_panels(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int row0,
                                            int head) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
    wgmma::tma_load_3d(dst + p * kPanelBytes, map, bar, p * kPanelCols, row0,
                       head);
}

// `bytes` contiguous bytes of global memory (16-byte aligned, a multiple
// of 16) into shared memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// C[64 x 64] = A[64 x W] B[64 x W]^T, A and B K-major tiles W wide.
template <int W>
__device__ __forceinline__ void issue_ss(float (&c)[32], uint32_t a,
                                         uint32_t b) {
  wgmma::Engine<W, W>::issue_qk(c, a, b);
}

// The pair (x0, x1) of an A fragment as two bf16 parts, hi = bf16(x) and
// lo = bf16(x - hi) (x - hi is exact in fp32): hi + lo holds x to about
// 2^-17 of itself.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const float h0 = round_to<__nv_bfloat16>(x0);
  const float h1 = round_to<__nv_bfloat16>(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - h0, x1 - h1);
}

// Accumulator register i of a 64 x N product holds row
// 16 warp + lane / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (lane & 3) + (i & 1); registers 8 kk .. 8 kk + 7, in
// pairs, are the A fragment of k16 step kk.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// The rows' max of a quad's four lanes (the lanes of one row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// dq: one warpgroup, 64 query rows
// ---------------------------------------------------------------------------

template <int Dk, int Dv, class Policy> struct DqCta {
  using L = Layout<Dk, Dv>;
  using Panels = typename L::Panels;
  static constexpr int kParts = DqShape<Dk>::kParts;
  static constexpr int kCols = DqShape<Dk>::kCols;
  const CUtensorMap *qmap, *kmap, *vmap, *dmap;
  Ring<Dk, Dv> ring;
  int bh, hkv, row0, Sq, Skv, n_walk, a1, b0;
  float scale_log2;
  Policy pol;
  // this thread's rows r_lo and r_lo + 8: max (log2 units), its share of
  // l, then 1 / l, its share of D_i, then D_i
  int r_lo;
  float m[2], l[2], il[2], d[2];
  float acc[kCols / 2];  // dQ / scale, this part's columns

  __device__ int kv0(int w) const {
    return pol.key_step(bh, row0, w, a1, b0) * kBK;
  }
  __device__ int n_steps() const { return (2 + kParts) * n_walk; }
  // step j = pass * n_walk + w: key tile w's K, and its V from pass 2 on
  __device__ __forceinline__ void load(int j) const {
    const int w = j % n_walk;
    const bool with_v = j >= n_walk;
    const uint32_t bar = ring.bar(1 + j % kStages);
    mbar_expect_tx(bar, L::kTileK + (with_v ? L::kTileV : 0));
    load_panels<Panels::kPanels>(ring.x(j), kmap, bar, kv0(w), hkv);
    if (with_v)
      load_panels<Panels::kVPanels>(ring.y(j), vmap, bar, kv0(w), hkv);
  }
  // the slot of step j is free again: refill it with step j + kStages
  __device__ __forceinline__ void release(int j) const {
    __syncthreads();  // every warp's wgmmas are done with the slot
    if (threadIdx.x == 0 && j + kStages < n_steps()) load(j + kStages);
  }

  // S (and dP) of step j, waited for; S scaled to log2 units, the hidden
  // pairs at kNegInf when kMask
  template <bool kMask, bool kDP>
  __device__ __forceinline__ void scores(int j, int kv, float (&s)[32],
                                         float (&dp)[32]) {
    ring.wait(j);
    fence_regs(s);
    if constexpr (kDP) fence_regs(dp);
    wgmma_fence();
    issue_ss<Dk>(s, ring.a(), ring.x(j));
    if constexpr (kDP) issue_ss<Dv>(dp, ring.b(), ring.y(j));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (kDP) fence_regs(dp);
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if constexpr (kMask) {
        const int key = kv + acc_col(i, lane);
        const int r = r_lo + acc_row(i);
        if (key >= Skv || !pol.visible(r, key)) x = kNegInf;
      }
      s[i] = x;
    }
  }
  template <bool kMask>
  __device__ __forceinline__ float prob(float x, int i) const {
    if (kMask && x == kNegInf) return 0.f;
    return fast_exp2(x - m[(i >> 1) & 1]);
  }
  __device__ bool masked(int kv) const {
    return kv + kBK > Skv || !pol.full(row0, row0 + kBQ - 1, kv, kv + kBK - 1);
  }

  // pass 1: the rows' max and sum
  template <bool kMask> __device__ __forceinline__ void pass_ml(int j, int kv) {
    float s[32], dp[32];
    scores<kMask, false>(j, kv, s, dp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      l[r] *= fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) l[(i >> 1) & 1] += prob<kMask>(s[i], i);
  }

  // pass 2: D_i's sum of round(p) dP
  template <bool kMask> __device__ __forceinline__ void pass_d(int j, int kv) {
    float s[32], dp[32];
    scores<kMask, true>(j, kv, s, dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      d[(i >> 1) & 1] += round_to<__nv_bfloat16>(prob<kMask>(s[i], i)) * dp[i];
  }

  // pass 3: dS = P (dP - D_i), in two bf16 parts, then dQ += dS K over
  // columns [part kCols, (part + 1) kCols)
  template <bool kMask>
  __device__ __forceinline__ void pass_dq(int j, int kv, int part) {
    float s[32], dp[32];
    scores<kMask, true>(j, kv, s, dp);
    uint32_t pa[4][4], pl[4][4];  // dS's hi and lo parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int r = e & 1;
        const float ds0 = prob<kMask>(s[i], i) * il[r] * (dp[i] - d[r]);
        const float ds1 =
            prob<kMask>(s[i + 1], i + 1) * il[r] * (dp[i + 1] - d[r]);
        split_bf16(ds0, ds1, pa[kk][e], pl[kk][e]);
      }
    fence_regs(acc);
    wgmma_fence();
    const uint32_t ks =
        ring.x(j) + part * (kCols / kPanelCols) * kPanelBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<kCols>(acc, pa[kk], mnmajor_desc(ks, kk));
      wgmma_pv<kCols>(acc, pl[kk], mnmajor_desc(ks, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pl);
  }

  // The three passes, dQ = scale * acc of the rows below Sq stored after
  // each part of pass 3, and the rows' m, 1 / l and D into stats (3, BH,
  // Sq_pad).
  __device__ __forceinline__ void run(__nv_bfloat16* __restrict__ dq,
                                      float* __restrict__ stats, int Sq_pad,
                                      float scale) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    r_lo = row0 + 16 * warp + lane / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = d[r] = 0.f;
    }
    if (n_walk > 0) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(ring.bar(0), L::kTileK + L::kTileV);
        load_panels<Panels::kPanels>(ring.a(), qmap, ring.bar(0), row0, bh);
        load_panels<Panels::kVPanels>(ring.b(), dmap, ring.bar(0), row0,
                                      bh);
        for (int j = 0; j < kStages && j < n_steps(); ++j) load(j);
      }
      mbar_wait(ring.bar(0), 0);
    }
    for (int w = 0; w < n_walk; ++w) {
      const int kv = kv0(w);
      if (masked(kv))
        pass_ml<true>(w, kv);
      else
        pass_ml<false>(w, kv);
      release(w);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) il[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-20f);
    for (int w = 0; w < n_walk; ++w) {
      const int j = n_walk + w, kv = kv0(w);
      if (masked(kv))
        pass_d<true>(j, kv);
      else
        pass_d<false>(j, kv);
      release(j);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) d[r] = il[r] * quad_sum(d[r]);
    // rows past Sq (to Sq_pad) get 0, 0, 0: dkdv copies the whole row
    // block and multiplies their 1 / l and D by its masked p = 0, so they
    // must be finite
    const size_t plane = (size_t)gridDim.y * Sq_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = r_lo + 8 * r;
      if ((lane & 3) == 0) {
        const bool live = g < Sq;
        float* st = stats + (size_t)bh * Sq_pad + g;
        st[0] = live ? m[r] : 0.f;
        st[plane] = live ? il[r] : 0.f;
        st[2 * plane] = live ? d[r] : 0.f;
      }
    }
    for (int part = 0; part < kParts; ++part) {
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
      for (int w = 0; w < n_walk; ++w) {
        const int j = (2 + part) * n_walk + w, kv = kv0(w);
        if (masked(kv))
          pass_dq<true>(j, kv, part);
        else
          pass_dq<false>(j, kv, part);
        release(j);
      }
      store(dq, part, scale);
    }
  }

  // this part's columns of dQ = scale * acc, rows below Sq
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ dq,
                                        int part, float scale) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = r_lo + 8 * r;
      if (g >= Sq) continue;
      __nv_bfloat16* row = dq + ((size_t)bh * Sq + g) * Dk + part * kCols;
#pragma unroll
      for (int c = 0; c < kCols / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * scale,
                                  acc[4 * c + 2 * r + 1] * scale);
    }
  }
};

// Grid (ceil(Sq / 64), BH); the heaviest query tiles (the last, under a
// causal mask) are scheduled first.
template <int Dk, int Dv, class Policy>
__global__ void __launch_bounds__(wgmma::kThreads)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap dmap,
                __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                int Sq, int Sq_pad, int Skv, int G, float scale,
                float scale_log2, Policy pol) {
  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  DqCta<Dk, Dv, Policy> cta;
  cta.ring.init(bwd_smem);
  cta.qmap = &qmap;
  cta.kmap = &kmap;
  cta.vmap = &vmap;
  cta.dmap = &dmap;
  cta.bh = blockIdx.y;
  cta.hkv = blockIdx.y / G;
  cta.row0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  cta.Sq = Sq;
  cta.Skv = Skv;
  cta.scale_log2 = scale_log2;
  cta.pol = pol;
  int b1;
  pol.key_tiles(cta.bh, cta.row0, min(cta.row0 + kBQ, Sq) - 1, Skv, kBK,
                cta.a1, cta.b0, b1);
  cta.n_walk = cta.a1 + max(b1 - cta.b0, 0);
  cta.run(dq, stats, Sq_pad, scale);
}

// ---------------------------------------------------------------------------
// dk / dv: 64 keys, one or two warpgroups
// ---------------------------------------------------------------------------

template <int Dk, int Dv, class Policy> struct DkdvCta {
  using L = Layout<Dk, Dv>;
  using Panels = typename L::Panels;
  const CUtensorMap *qmap, *dmap;
  const float* stats;
  Ring<Dk, Dv> ring;
  int bkv, c0, G, Sq, Sq_pad, Skv, t0, nt;
  float scale_log2;
  Policy pol;

  // A range policy's walk is written out here, as it was before the
  // policies gave walks: routed through the policy's methods, the same
  // arithmetic compiled to other SASS for these kernels (the dq kernel's
  // did not move).
  __device__ int n_steps() const {
    if constexpr (Policy::kLists) return nt;
    return G * nt;
  }
  __device__ int rq0(int j) const {
    if constexpr (Policy::kLists) return pol.step_tile(bkv, c0, j) * kBQ;
    return (t0 + j % nt) * kBQ;
  }
  __device__ int head(int j) const {
    if constexpr (Policy::kLists) return pol.step_head(bkv, c0, j, G);
    return bkv * G + j / nt;
  }
  // step j: query head bkv G + j / nt, query tile t0 + j % nt (a range
  // policy), or the policy's list entry j: its Q and dO rows and their m,
  // 1 / l and D
  __device__ __forceinline__ void load(int j) const {
    const int bh = head(j), r0 = rq0(j);
    const uint32_t bar = ring.bar(1 + j % kStages);
    mbar_expect_tx(bar, L::kTileK + L::kTileV + kStatsBytes);
    load_panels<Panels::kPanels>(ring.x(j), qmap, bar, r0, bh);
    load_panels<Panels::kVPanels>(ring.y(j), dmap, bar, r0, bh);
    const size_t plane = (size_t)gridDim.y * G * Sq_pad;
    const float* st = stats + (size_t)bh * Sq_pad + r0;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      bulk_load(ring.stats(j) + p * kPlaneBytes, st + p * plane, kPlaneBytes,
                bar);
  }

  // Steps of the walk on this warpgroup's share: dK (kK) and / or dV
  // (kV), accumulated over every step, then stored (rows below Skv).
  template <bool kK, bool kV>
  __device__ __forceinline__ void run(__nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, float scale) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int key_lo = c0 + 16 * warp + lane / 4;  // and key_lo + 8
    float gk[kK ? Dk / 2 : 1], gv[kV ? Dv / 2 : 1];
#pragma unroll
    for (int i = 0; i < (kK ? Dk / 2 : 1); ++i) gk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kV ? Dv / 2 : 1); ++i) gv[i] = 0.f;
    const int n = n_steps();
    if (n > 0) mbar_wait(ring.bar(0), 0);
    for (int j = 0; j < n; ++j) {
      const int r0 = rq0(j);
      const bool mask = r0 + kBQ > Sq || c0 + kBK > Skv ||
                        !pol.full(r0, r0 + kBQ - 1, c0, c0 + kBK - 1);
      if (mask)
        step<true, kK, kV>(j, r0, key_lo, gk, gv);
      else
        step<false, kK, kV>(j, r0, key_lo, gk, gv);
      __syncthreads();  // every warpgroup's wgmmas are done with the slot
      if (threadIdx.x == 0 && j + kStages < n) load(j + kStages);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + 8 * r;
      if (key >= Skv) continue;
      if constexpr (kK) {
        __nv_bfloat16* row = dk + ((size_t)bkv * Skv + key) * Dk;
#pragma unroll
        for (int c = 0; c < Dk / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + 2 * (lane & 3)) =
              __floats2bfloat162_rn(gk[4 * c + 2 * r] * scale,
                                    gk[4 * c + 2 * r + 1] * scale);
      }
      if constexpr (kV) {
        __nv_bfloat16* row = dv + ((size_t)bkv * Skv + key) * Dv;
#pragma unroll
        for (int c = 0; c < Dv / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + 2 * (lane & 3)) =
              __floats2bfloat162_rn(gv[4 * c + 2 * r], gv[4 * c + 2 * r + 1]);
      }
    }
  }

  // One step: S^T = K Q^T (and dP^T = V dO^T for dK); per pair (key row,
  // query column) p = exp2(s - m_q), round(p) / l_q and
  // dS = p / l_q (dP - D_q), each in two bf16 parts; dV += round(P^T)/l dO
  // and dK += dS^T Q.
  template <bool kMask, bool kK, bool kV>
  __device__ __forceinline__ void step(int j, int r0, int key_lo,
                       float (&gk)[kK ? Dk / 2 : 1],
                       float (&gv)[kV ? Dv / 2 : 1]) {
    const int lane = threadIdx.x % 32;
    float s[32], dp[32];
    ring.wait(j);
    fence_regs(s);
    if constexpr (kK) fence_regs(dp);
    wgmma_fence();
    issue_ss<Dk>(s, ring.a(), ring.x(j));
    if constexpr (kK) issue_ss<Dv>(dp, ring.b(), ring.y(j));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (kK) fence_regs(dp);
    const float* st = ring.stats_ptr(j);
    uint32_t pv[4][4], pvl[4][4], pk[4][4], pkl[4][4];  // hi and lo parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int c = acc_col(i, lane);  // even: columns c and c + 1
        const float2 mq = *reinterpret_cast<const float2*>(st + c);
        const float2 lq =
            *reinterpret_cast<const float2*>(st + kBQ + c);
        float p0 = fast_exp2(s[i] * scale_log2 - mq.x);
        float p1 = fast_exp2(s[i + 1] * scale_log2 - mq.y);
        if constexpr (kMask) {
          const int key = key_lo + acc_row(i);
          if (key >= Skv || r0 + c >= Sq || !pol.visible(r0 + c, key))
            p0 = 0.f;
          if (key >= Skv || r0 + c + 1 >= Sq ||
              !pol.visible(r0 + c + 1, key))
            p1 = 0.f;
        }
        if constexpr (kV)
          split_bf16(round_to<__nv_bfloat16>(p0) * lq.x,
                     round_to<__nv_bfloat16>(p1) * lq.y, pv[kk][e],
                     pvl[kk][e]);
        if constexpr (kK) {
          const float2 dq_ = *reinterpret_cast<const float2*>(st + 2 * kBQ + c);
          split_bf16(p0 * lq.x * (dp[i] - dq_.x),
                     p1 * lq.y * (dp[i + 1] - dq_.y), pk[kk][e], pkl[kk][e]);
        }
      }
    if constexpr (kK) fence_regs(gk);
    if constexpr (kV) fence_regs(gv);
    wgmma_fence();
    if constexpr (kV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<Dv>(gv, pv[kk], mnmajor_desc(ring.y(j), kk));
        wgmma_pv<Dv>(gv, pvl[kk], mnmajor_desc(ring.y(j), kk));
      }
    }
    if constexpr (kK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<Dk>(gk, pk[kk], mnmajor_desc(ring.x(j), kk));
        wgmma_pv<Dk>(gk, pkl[kk], mnmajor_desc(ring.x(j), kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (kK) {
      fence_regs(gk);
      fence_regs(pk);
      fence_regs(pkl);
    }
    if constexpr (kV) {
      fence_regs(gv);
      fence_regs(pv);
      fence_regs(pvl);
    }
  }
};

// Grid (ceil(Skv / 64), BHkv); the heaviest key tiles (the first, under a
// causal mask) are scheduled first.
template <int Dk, int Dv, class Policy>
__global__ void __launch_bounds__(DkdvShape<Dk, Dv>::kThreads)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int Sq, int Sq_pad,
                  int Skv, int G, float scale, float scale_log2,
                  Policy pol) {
  using L = Layout<Dk, Dv>;
  using Panels = typename L::Panels;
  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  DkdvCta<Dk, Dv, Policy> cta;
  cta.ring.init(bwd_smem);
  cta.qmap = &qmap;
  cta.dmap = &dmap;
  cta.stats = stats;
  cta.bkv = blockIdx.y;
  cta.c0 = blockIdx.x * kBK;
  cta.G = G;
  cta.Sq = Sq;
  cta.Sq_pad = Sq_pad;
  cta.Skv = Skv;
  cta.scale_log2 = scale_log2;
  cta.pol = pol;
  int t1;
  pol.query_tiles(cta.bkv, cta.c0, min(cta.c0 + kBK, Skv) - 1, Sq, kBQ,
                  cta.t0, t1);
  cta.nt = max(t1 - cta.t0, 0);
  if (threadIdx.x == 0 && cta.n_steps() > 0) {
    const uint32_t bar = cta.ring.bar(0);
    mbar_expect_tx(bar, L::kTileK + L::kTileV);
    load_panels<Panels::kPanels>(cta.ring.a(), &kmap, bar, cta.c0, cta.bkv);
    load_panels<Panels::kVPanels>(cta.ring.b(), &vmap, bar, cta.c0,
                                  cta.bkv);
    for (int j = 0; j < kStages && j < cta.n_steps(); ++j) cta.load(j);
  }
  if constexpr (DkdvShape<Dk, Dv>::kTwo) {
    if (threadIdx.x < wgmma::kThreads)
      cta.template run<true, false>(dk, dv, scale);
    else
      cta.template run<false, true>(dk, dv, scale);
  } else {
    cta.template run<true, true>(dk, dv, scale);
  }
}

// Both kernels on `stream`, dq's first (dkdv reads its stats). q, dout
// (BH, Sq, Dk / Dv), k, v (BHkv, Skv, Dk / Dv), all contiguous bf16 with
// 16-byte aligned bases; stats (3, BH, Sq_pad) float32 scratch, Sq_pad = Sq
// rounded up to 64, 16-byte aligned.
template <int Dk, int Dv, class Policy>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int BH, int BHkv, int Sq, int Skv,
                   float scale, Policy pol, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(stats) % 16 != 0)
    return cudaErrorMisalignedAddress;
  wgmma::Maps maps;
  cudaError_t e = maps.make(q, k, v, BH, BHkv, Sq, Skv, Dk, Dv);
  CUtensorMap dmap;
  if (e == cudaSuccess) e = wgmma::make_map(&dmap, dout, BH, Sq, Dv);
  if (e != cudaSuccess) return e;
  const size_t bytes = Layout<Dk, Dv>::kBytes;
  auto kq = dq_wgmma_kernel<Dk, Dv, Policy>;
  auto kkv = dkdv_wgmma_kernel<Dk, Dv, Policy>;
  e = allow_smem(kq, bytes);
  if (e == cudaSuccess) e = allow_smem(kkv, bytes);
  if (e != cudaSuccess) return e;
  const int G = BH / BHkv;
  const int Sq_pad = (Sq + kBQ - 1) / kBQ * kBQ;
  const float scale_log2 = scale * kLog2e;
  kq<<<dim3(Sq_pad / kBQ, BH), wgmma::kThreads, bytes, stream>>>(
      maps.q, maps.k, maps.v, dmap, static_cast<__nv_bfloat16*>(dq), stats,
      Sq, Sq_pad, Skv, G, scale, scale_log2, pol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((Skv + kBK - 1) / kBK, BHkv), DkdvShape<Dk, Dv>::kThreads,
        bytes, stream>>>(maps.q, maps.k, maps.v, dmap, stats,
                         static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv), Sq, Sq_pad, Skv, G,
                         scale, scale_log2, pol);
  return cudaSuccess;
}

}  // namespace wg
}  // namespace bwd
}  // namespace flux
