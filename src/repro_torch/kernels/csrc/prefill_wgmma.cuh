// Tensor-core prefill engine for bf16 operands on Hopper (sm_90a).
//
// The bf16 counterpart of PrefillBlock (attention_common.cuh), used by the
// flash, block-sparse and streaming kernels. One CTA of one warpgroup (128
// threads) owns 64 query rows of one (b, h) row and walks a caller-chosen
// list of 64-key tiles with the online softmax, masking keys past Skv, past
// the diagonal when causal, and those of a compile-time extra policy
// (StreamingMask), only on the tiles that need it. It computes what
// PrefillBlock and the TPU kernels compute: fp32 scores, the mask value
// -1e30, p rounded to bf16 before the PV product while l sums the
// unrounded p, and acc / max(l, 1e-20). The scores are kept in log2 units
// (scale * log2 e folded into one multiply, the SFU's exp2 in place of
// exp); the mask and the running max follow them, so a fully masked row
// behaves as it does on the TPU (p = 1 until a live key erases it through
// alpha = 0).
//
// The machine underneath:
// - TMA. Q is loaded once, K and V tiles into kStages slots each, every
//   slot completing on its own mbarrier. The tensor maps are 3-D over
//   (rows, seq, D), so rows past seq read as zeros (the TPU kernels pad
//   with zeros) and never the next head's rows. Thread 0 keeps the next
//   tile's loads in flight while the warpgroup computes.
// - Layout. Every 64-row tile is D / 32 column panels of 64 rows x 32 bf16
//   (64 bytes a row) under the 64-byte swizzle, one TMA box per panel. A
//   192-byte row (D = 96) does not fit the 128-byte swizzle atom; 64-byte
//   panels serve all four head dims with one layout.
// - wgmma. S = Q K^T is m64n64k16 with Q and K K-major in shared memory:
//   the descriptors step 32 bytes per k16 inside a panel and a panel's
//   4096 bytes between panels. O += P V is m64nDk16 with P in registers and
//   V MN-major in shared memory (the transpose bit for B): 512 bytes
//   between 8-key groups, a panel's bytes between 32-column groups.
// - The S accumulator's registers are the A fragments of the PV product
//   once pairs are packed to bf16; that packing is where p is rounded.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "attention_common.cuh"

namespace flux {
namespace wgmma {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kPanelCols = 32;  // bf16 columns of one 64-byte panel
constexpr uint32_t kPanelBytes = kBK * kPanelCols * 2;  // 4096
constexpr uint32_t kGroupBytes = 8 * kPanelCols * 2;  // 8 rows of a panel
constexpr int kStages = 2;  // K / V slots: 3 CTAs share an SM at D = 96

// One box of a 3-D tensor map into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until every committed group of this warp's wgmmas is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the registers in program order around the asynchronous wgmma, so
// the compiler neither reads an accumulator before wgmma_wait_all nor
// moves a write to it past the wgmma that reads it.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments, which a wgmma reads after it is issued.
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// sm90 matrix descriptor of a 64-byte-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 2 = B64.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// K-major operand (Q as A, K as B of S = Q K^T): the k16 step kk of a tile,
// 32 bytes into its panel; 8-row groups 512 bytes apart (the leading offset
// is unused for a swizzled K-major operand).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw64_desc(tile + (kk >> 1) * kPanelBytes + (kk & 1) * 32, 16,
                   kGroupBytes);
}

// MN-major operand (V as B of O += P V): keys [16 kk, 16 kk + 16) of a
// tile. Along N the 32-column groups are panels (leading offset), along K
// the 8-key groups are 512 bytes apart (stride offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw64_desc(tile + kk * 2 * kGroupBytes, kPanelBytes, kGroupBytes);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, b);
  if constexpr (D == 64) wgmma_rs_n64(o, a, b);
  if constexpr (D == 96) wgmma_rs_n96(o, a, b);
  if constexpr (D == 128) wgmma_rs_n128(o, a, b);
}

// Extra mask policies of Engine::run, on top of its Skv and causal tests.
// Each gives, for step j of the walk, the keys a query position does not
// see (hidden) and whether a 64-key tile at kv0 holds any such key for
// some row of the 64-query block at row0 (needs_mask); a tile that needs
// no mask runs the softmax without one.

// Flash and block-sparse: nothing beyond Skv and the diagonal. Both tests
// fold to false, and with the policy passed by value these kernels compile
// to the SASS they had without one (a const reference did not).
struct NoExtraMask {
  __device__ bool hidden(int, int, int) const { return false; }
  __device__ bool needs_mask(int, int, int) const { return false; }
};

// Streaming (sink + local), with causal = true: position p sees key c iff
// c < Skv, c <= p and, in the sink pass (steps j < n_sink), c < sink; in
// the window pass, c >= sink and p - c < local. A tile that straddles
// `sink` is walked once in each pass, with disjoint masks. last_q is the
// block's last stored query position, whose window starts highest.
struct StreamingMask {
  int sink;
  int local;
  int n_sink;
  int last_q;
  __device__ bool hidden(int j, int key, int pos) const {
    return j < n_sink ? key >= sink : key < sink || pos - key >= local;
  }
  __device__ bool needs_mask(int j, int kv0, int) const {
    return j < n_sink ? kv0 + kBK > sink
                      : kv0 < sink || kv0 < last_q - (local - 1);
  }
};

// Byte offsets inside the CTA's shared memory, from a 1024-byte aligned
// base: Q, kStages K tiles, kStages V tiles, the mbarriers (Q's, then one
// per K slot and one per V slot), the live-tile count and the list of live
// tiles.
template <int D> struct Layout {
  static_assert(D % kPanelCols == 0 && D <= 128, "head dim");
  static constexpr int kPanels = D / kPanelCols;
  static constexpr uint32_t kTile = kPanels * kPanelBytes;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBars = kV + kStages * kTile;
  static constexpr uint32_t kCount = kBars + 8 * (1 + 2 * kStages);
  static constexpr uint32_t kList = kCount + 16;
  // what a launch asks for: the slack that aligns the base, and n_list ints
  static size_t bytes(int n_list) {
    return 1024 + kList + sizeof(int) * (size_t)n_list;
  }
};

template <int D> struct Engine {
  using L = Layout<D>;
  static constexpr int kO = D / 2;  // O accumulator registers per thread

  uint32_t base;  // shared address of the aligned base
  int* list;      // the live tiles (block-sparse)
  int* count;
  // this thread's rows r0 = 16 warp + lane / 4 and r0 + 8: running max
  // (log2 units), this thread's share of l, and its O registers
  float m[2], l[2], o[kO];

  __device__ void init(uint8_t* smem) {
    const uint32_t raw = smem_u32(smem);
    const uint32_t pad = (1024 - (raw & 1023)) & 1023;
    base = raw + pad;
    list = reinterpret_cast<int*>(smem + pad + L::kList);
    count = reinterpret_cast<int*>(smem + pad + L::kCount);
    if (threadIdx.x == 0) {
      for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(bar(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
  }

  // barrier 0 is Q's, 1 + s K slot s's, 1 + kStages + s V slot s's
  __device__ uint32_t bar(int i) const { return base + L::kBars + 8 * i; }
  __device__ uint32_t k_slot(int t) const {
    return base + L::kK + (t % kStages) * L::kTile;
  }
  __device__ uint32_t v_slot(int t) const {
    return base + L::kV + (t % kStages) * L::kTile;
  }

  // The entries >= 0 of one selection row, in order, into `list` (warp 0,
  // 32 entries a step); returns their number. Ends the CTA's set-up.
  __device__ int compact(const int* __restrict__ sel, int n_sel) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0;
      for (int c0 = 0; c0 < n_sel; c0 += 32) {
        const int t = c0 + lane < n_sel ? sel[c0 + lane] : -1;
        const unsigned live = __ballot_sync(0xffffffffu, t >= 0);
        if (t >= 0) list[n + __popc(live & ((1u << lane) - 1))] = t;
        n += __popc(live);
      }
      if (lane == 0) *count = n;
    }
    __syncthreads();
    return *count;
  }

  // Rows [row0, row0 + 64) of a (rows, seq, D) map's row `head` into the
  // tile at dst, one box per panel.
  __device__ static void load_tile(uint32_t dst, const CUtensorMap* map,
                                   uint32_t mbar, int row0, int head) {
    mbar_expect_tx(mbar, L::kTile);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load_3d(dst + p * kPanelBytes, map, mbar, p * kPanelCols, row0,
                  head);
  }

  // Tile t of the walk (key tile `tile`) into its K / V slot.
  __device__ void load_k(int t, int tile, const CUtensorMap* kmap,
                         int head) const {
    load_tile(k_slot(t), kmap, bar(1 + t % kStages), tile * kBK, head);
  }
  __device__ void load_v(int t, int tile, const CUtensorMap* vmap,
                         int head) const {
    load_tile(v_slot(t), vmap, bar(1 + kStages + t % kStages), tile * kBK,
              head);
  }

  // Issues S = Q K^T for the K tile at ks (D / 16 k16 steps).
  __device__ static void issue_qk(float (&s)[32], uint32_t qs, uint32_t ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(qs, kk), kmajor_desc(ks, kk), kk > 0);
  }

  // Issues O += P V for the V tile at vs (64 keys, 4 k16 steps).
  __device__ void issue_pv(const uint32_t (&pa)[4][4], uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(o, pa[kk], mnmajor_desc(vs, kk));
  }

  // The online softmax of one score tile of keys [kv0, kv0 + 64), step j
  // of the walk: scales s to log2 units, masks it when kMask (a tile that
  // crosses the diagonal or Skv, or one the extra policy says needs it),
  // updates m and l (l sums the unrounded p) and packs p to bf16 into pa,
  // the A fragments of the PV product; alpha rescales O's rows.
  // Register i of s holds row 16 warp + lane / 4 + 8 ((i >> 1) & 1), key
  // kv0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1); the A fragment of k16 step
  // kk is registers 8 kk .. 8 kk + 7 in pairs.
  template <bool kMask, class Extra>
  __device__ void softmax(float (&s)[32], int j, int kv0, int pos0, int Skv,
                          bool causal, Extra extra, float scale_log2,
                          uint32_t (&pa)[4][4], float (&alpha)[2]) {
    const int lane = threadIdx.x % 32;
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};  // row r: 2 chains
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if constexpr (kMask) {
        const int key = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int pos = pos0 + 8 * ((i >> 1) & 1);
        if (key >= Skv || (causal && key > pos) || extra.hidden(j, key, pos))
          x = kNegInf;
      }
      s[i] = x;
      mx[((i >> 1) & 1) + 2 * (i & 1)] =
          fmaxf(mx[((i >> 1) & 1) + 2 * (i & 1)], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row share a quad
      float v = fmaxf(mx[r], mx[r + 2]);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float m_new = fmaxf(m[r], v);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float p0 = fast_exp2(s[i] - m[e & 1]);
        const float p1 = fast_exp2(s[i + 1] - m[e & 1]);
        sum[e] += p0 + p1;
        pa[kk][e] = pack_bf16(p0, p1);
      }
    l[0] += sum[0] + sum[2];
    l[1] += sum[1] + sum[3];
  }

  // Query rows [row0, row0 + 64) of q row `head_q` over n_tiles key tiles
  // of k / v row `head_kv`, tile_of(j) the j-th. Query row r sits at
  // position q_offset + r and sees key c of step j iff c < Skv, when
  // causal c <= q_offset + r, and extra.hidden(j, c, q_offset + r) is
  // false. Rows past Sq are never stored, so they may go unmasked.
  // Each tile: S = Q K^T, the softmax, O += P V, each product waited for;
  // the next kStages - 1 tiles' loads are in flight meanwhile, and the
  // CTA's neighbours on the SM fill the tensor cores during its softmax.
  template <class TileOf, class Extra = NoExtraMask>
  __device__ void run(const CUtensorMap* qmap, const CUtensorMap* kmap,
                      const CUtensorMap* vmap, int head_q, int head_kv,
                      int row0, int n_tiles, TileOf tile_of, int Skv,
                      bool causal, int q_offset, float scale_log2,
                      Extra extra = Extra()) {
    if (n_tiles == 0) return;  // nothing loaded: o and l stay 0
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int pos0 = q_offset + row0 + 16 * warp + lane / 4;
    const uint32_t qs = base + L::kQ;
    if (threadIdx.x == 0) {
      load_tile(qs, qmap, bar(0), row0, head_q);
      for (int t = 0; t < kStages && t < n_tiles; ++t) {
        load_k(t, tile_of(t), kmap, head_kv);
        load_v(t, tile_of(t), vmap, head_kv);
      }
    }
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    uint32_t pa[4][4];
    float alpha[2];
    mbar_wait(bar(0), 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int kv0 = tile_of(j) * kBK;
      const uint32_t phase = (j / kStages) & 1;
      mbar_wait(bar(1 + j % kStages), phase);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, qs, k_slot(j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool edge = kv0 + kBK > Skv ||
                        (causal && kv0 + kBK - 1 > q_offset + row0) ||
                        extra.needs_mask(j, kv0, row0);
      if (edge)
        softmax<true>(s, j, kv0, pos0, Skv, causal, extra, scale_log2, pa,
                      alpha);
      else
        softmax<false>(s, j, kv0, pos0, Skv, causal, extra, scale_log2, pa,
                       alpha);
      // alpha is 1 once a row's max has settled: skip the rescale when it
      // is 1 for all the warp's rows (bit-identical, and 64-key tiles deep
      // into a long prefix mostly leave the max where it was)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      mbar_wait(bar(1 + kStages + j % kStages), phase);
      fence_regs(o);
      wgmma_fence();
      issue_pv(pa, v_slot(j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);

      __syncthreads();  // every warp's wgmmas are done with this slot
      if (threadIdx.x == 0 && j + kStages < n_tiles) {
        load_k(j + kStages, tile_of(j + kStages), kmap, head_kv);
        load_v(j + kStages, tile_of(j + kStages), vmap, head_kv);
      }
    }
  }

  // acc / max(l, 1e-20) of the rows below Sq into o_row (Sq, D).
  __device__ void store(__nv_bfloat16* __restrict__ o_row, int row0,
                        int Sq) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // one reciprocal per row in place of D / 4 divisions (within an fp32
      // ulp of acc / max(l, 1e-20), far below the bf16 output's rounding)
      const float inv = __frcp_rn(fmaxf(sum, 1e-20f));
      const int g = row0 + 16 * warp + lane / 4 + 8 * r;
      if (g >= Sq) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(
            o_row + (size_t)g * D + 8 * c + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                  o[4 * c + 2 * r + 1] * inv);
    }
  }
};

// ---------------------------------------------------------------------------
// Host side: tensor maps, encoded on every call (the pointers change).
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library links no libcuda of its own.
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A contiguous (rows, seq, D) bf16 tensor as a 3-D map with boxes of one
// panel (32 columns x 64 rows) under the 64-byte swizzle; reads past seq
// are zeros. TMA needs a 16-byte aligned base (the row stride, 2 D bytes,
// is a multiple of 16 for every built head dim).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows,
                            int seq, int D) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorMisalignedAddress;
  EncodeTiled encode;
  cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)seq,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)seq * D * 2};
  const cuuint32_t box[3] = {kPanelCols, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of q (BH, Sq, D) and k / v (BHkv, Skv, D).
struct Maps {
  CUtensorMap q, k, v;
  cudaError_t make(const void* qp, const void* kp, const void* vp, int BH,
                   int BHkv, int Sq, int Skv, int D) {
    cudaError_t e = make_map(&q, qp, BH, Sq, D);
    if (e == cudaSuccess) e = make_map(&k, kp, BHkv, Skv, D);
    if (e == cudaSuccess) e = make_map(&v, vp, BHkv, Skv, D);
    return e;
  }
};

}  // namespace wgmma
}  // namespace flux

// Dynamic shared memory one CTA of the engine asks for at head dim D with a
// tile list of n_list entries (0 for flash); -1 for a head dim not built.
extern "C" int flux_wgmma_smem_bytes(int D, int n_list) {
  switch (D) {
    case 32: return (int)flux::wgmma::Layout<32>::bytes(n_list);
    case 64: return (int)flux::wgmma::Layout<64>::bytes(n_list);
    case 96: return (int)flux::wgmma::Layout<96>::bytes(n_list);
    case 128: return (int)flux::wgmma::Layout<128>::bytes(n_list);
  }
  return -1;
}
