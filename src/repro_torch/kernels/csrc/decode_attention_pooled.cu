// One-token decode attention for the continuous-batching slot pool, for
// Hopper (sm_90a): split-KV over each slot's live length, with a
// log-sum-exp merge.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pooled_bh, body _pooled_kernel). Same function: row b
// of q belongs to slot b / n_heads and reads key row b / G. Each slot has
// its own live length n = min(lengths[slot], L) and its own positions row
// (-1 marks an empty ring entry); column j is visible iff j < n and
// positions[slot, j] >= 0. There is no cur_pos test: the caller marks the
// ring entries a slot must not see -1. A null positions pointer means that
// column j holds position j (the FullKV layout), so nothing is read for it.
// A row that sees no column (n = 0, or every live entry -1) writes zeros.
//
// What bounds it: the bytes of the live prefixes of K and V (one query
// token does two FMAs per cached element), so the card's time should
// follow the pool's live bytes, not its longest slot. The TPU kernel walks
// a row's live key blocks along a sequential grid axis; here each KV row's
// capacity is cut into R = ceil(ceil(L / 64) / tiles) ranges of `tiles`
// whole 64-key tiles, one CTA each:
// - Grid (BHkv, R, ceil(G / kG)), built from the capacity, so the host
//   never reads `lengths` (no device-to-host copy per layer and step).
//   Each CTA reads its slot's length itself; a CTA whose range starts at
//   or past the slot's last live tile returns at once, reading nothing,
//   and the last live tile is read only up to the live length. Ranges of a
//   fixed size give every working CTA the same bytes whatever its slot's
//   depth, so a deep slot no longer holds the card while the others idle.
// - The CTA is the batch decode kernel's (decode_attention.cu), with the
//   helpers of decode_split.cuh: its K and V tiles by 1-D TMA bulk copies
//   into a ring of mbarrier slots whose waits trap after 2^24 polls, a K
//   pass writing raw scores to shared memory, one softmax over the range
//   (fp32, log2 units, -1e30 mask, p rounded to the operand dtype while l
//   sums the unrounded p), then a V pass. The range's positions come by
//   cp.async (none for the FullKV layout); a key is live iff its position
//   is >= 0. The batch kernel keeps its own copy of the body, so that its
//   compiled code stays as it was.
// - Merge. With R = 1 the CTA writes the output. Otherwise each range
//   that ran leaves its fp32 (acc, m, l) in scratch the caller allocates,
//   and a second kernel of the same C entry reads the slot's length again
//   to know which ranges ran, and computes o = sum_s w_s acc_s /
//   max(sum_s w_s l_s, 1e-20), w_s = exp2(m_s - max_s m_s): a range whose
//   keys are all masked (ring holes) has m_s = -1e30 and is erased as soon
//   as any range of the row has a live key; a row with none gives zeros.
#include "decode_split.cuh"
#include "prefill_wgmma.cuh"

namespace flux {
namespace split {

// The live length of slot s: lengths[s] clamped to [0, L].
__device__ __forceinline__ int live_length(const int* lengths, int s,
                                           int L) {
  return min(max(lengths[s], 0), L);
}

// One CTA: range blockIdx.y of KV row blockIdx.x (slot blockIdx.x /
// kv_per_slot, live length n_live), tiles [t0, t0 + n) with t0 =
// blockIdx.y * tiles cut at n_live, for query rows b = blockIdx.x * G + g0
// + g (g < n_g). A range at or past the slot's last live tile returns at
// once. Its walk is 2 n chunks: K tile j for chunk j < n, V tile j - n for
// chunk j >= n.
template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
pooled_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ positions,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int L, int G,
                    int kv_per_slot, int tiles, float scale_log2) {
  using P = Plan<T, D, kG>;
  constexpr int kE = P::kE, kStages = P::kStages;
  constexpr int kHalf = P::kVecs / 2;  // vectors of a row in one lane
  constexpr size_t kRow = (size_t)D * sizeof(T);
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_row = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int g0 = blockIdx.z * kG;
  const int n_g = min(kG, G - g0);
  const int slot = kv_row / kv_per_slot;
  const int n_live = live_length(lengths, slot, L);
  const int live_tiles = (n_live + kKeys - 1) / kKeys;
  const int t0 = split * tiles;
  if (t0 >= live_tiles) {  // past the slot's live keys: nothing to read
    if (n_split == 1)  // n_live = 0 and no merge: the rows are zeros
      for (int i = tid; i < n_g * D; i += kThreads)
        o[((size_t)kv_row * G + g0) * D + i] = from_float<T>(0.f);
    return;
  }
  const int n = min(tiles, live_tiles - t0);
  const int key_first = t0 * kKeys;
  const int n_keys = min((t0 + n) * kKeys, n_live) - key_first;
  const uint8_t* kr = reinterpret_cast<const uint8_t*>(k) +
                      ((size_t)kv_row * L + key_first) * kRow;
  const uint8_t* vr = reinterpret_cast<const uint8_t*>(v) +
                      ((size_t)kv_row * L + key_first) * kRow;
  const uint32_t base = smem_u32(smem);
  float* qs = reinterpret_cast<float*>(smem + P::kQ);
  float* red = reinterpret_cast<float*>(smem + P::kRed);
  int* pos_s = reinterpret_cast<int*>(smem + P::kPos);
  float* sc = reinterpret_cast<float*>(pos_s + n * kKeys);
  const int ld = n * kKeys;  // row g of the scores: sc[g * ld + key]

  auto bar = [&](int c) { return base + P::kBars + 8 * (c % kStages); };
  auto issue = [&](int c) {  // chunk c into slot c % kStages
    const int t = c < n ? c : c - n;
    const uint32_t bytes = min(kKeys, n_keys - t * kKeys) * (uint32_t)kRow;
    mbar_expect_tx(bar(c), bytes);
    bulk_load(base + (c % kStages) * P::kChunk,
              (c < n ? kr : vr) + (size_t)t * kKeys * kRow, bytes, bar(c));
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised
  if (tid == 0)
    for (int c = 0; c < kStages && c < 2 * n; ++c) issue(c);
  if (positions == nullptr) {  // FullKV: every key below n_live is live
    for (int i = tid; i < n_keys; i += kThreads) pos_s[i] = 0;
  } else {
    const int* prow = positions + (size_t)slot * L + key_first;
    for (int i = tid; i < n_keys; i += kThreads)
      cp_async4(smem_u32(pos_s + i), prow + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = tid; i < n_g * D; i += kThreads)
    qs[i] = to_float(q[((size_t)kv_row * G + g0) * D + i]);
  __syncthreads();  // q is in shared memory

  // pass K: lanes 2 i and 2 i + 1 of warp w score key 16 w + i of a tile,
  // lane h taking the row's 16-byte vectors 2 j + h
  const int my_key = 16 * warp + lane / 2, h = lane & 1;
  float qv[kG == 1 ? kHalf * kE : 1];
  if constexpr (kG == 1) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
#pragma unroll
      for (int e = 0; e < kE; ++e) qv[j * kE + e] = qs[(2 * j + h) * kE + e];
  }
  // pass V: thread (group, vec) takes keys group, group + kGroups, .. of a
  // tile and the row's 16-byte vector vec
  const int vec = tid % P::kVecs, grp = tid / P::kVecs;
  float acc[kG][kE], m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;

  for (int c = 0; c < 2 * n; ++c) {
    mbar_wait(bar(c), (c / kStages) & 1);
    const uint8_t* st = smem + (c % kStages) * P::kChunk;
    if (c < n) {
      const int kl = c * kKeys + my_key;  // the key within the split
      float dot[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) dot[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        float x[kE];
        load_vec(st + my_key * kRow + (2 * j + h) * 16, x);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g >= n_g) break;
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            float qe;
            if constexpr (kG == 1)
              qe = qv[j * kE + e];
            else
              qe = qs[g * D + (2 * j + h) * kE + e];
            dot[g] = fmaf(qe, x[e], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
        if (g < n_g && h == 0 && kl < n_keys) sc[g * ld + kl] = dot[g];
      }
    } else {
      if (c == n) {
        // the split's softmax: scores to log2 units, masked to -1e30 after
        // the scaling; p = exp2(s - m) rounded to T, l sums the unrounded p
        cp_async_wait_all();
        __syncthreads();  // the positions and every score are in place
#pragma unroll
        for (int g = 0; g < kG; ++g) m[g] = kNegInf;
        for (int i = tid; i < n_keys; i += kThreads) {
          const int p = pos_s[i];
          const bool live = p >= 0;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g >= n_g) break;
            const float x = live ? sc[g * ld + i] * scale_log2 : kNegInf;
            sc[g * ld + i] = x;
            m[g] = fmaxf(m[g], x);
          }
        }
        block_reduce<true>(m, red);
#pragma unroll
        for (int g = 0; g < kG; ++g) l[g] = 0.f;
        for (int i = tid; i < n_keys; i += kThreads) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g >= n_g) break;
            const float p = fast_exp2(sc[g * ld + i] - m[g]);
            l[g] += p;
            sc[g * ld + i] = round_to<T>(p);
          }
        }
        block_reduce<false>(l, red);  // its barrier publishes the p
      }
      const int t = c - n;
      const int rows = min(kKeys, n_keys - t * kKeys);
      if (grp < P::kGroups) {
        for (int r = grp; r < rows; r += P::kGroups) {
          float x[kE];
          load_vec(st + r * kRow + vec * 16, x);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g >= n_g) break;
            const float p = sc[g * ld + t * kKeys + r];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this chunk's slot
    if (tid == 0 && c + kStages < 2 * n) issue(c + kStages);
  }

  // the key groups' sums, row by row, through the (now idle) slots
  float* area = reinterpret_cast<float*>(smem);  // (kGroups, D)
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g >= n_g) break;
    if (grp < P::kGroups)
#pragma unroll
      for (int e = 0; e < kE; ++e) area[grp * D + vec * kE + e] = acc[g][e];
    __syncthreads();
    const size_t b = (size_t)kv_row * G + g0 + g;
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < P::kGroups; ++r) a += area[r * D + d];
      if (n_split == 1) {  // no live key (m = -1e30): zeros
        o[b * D + d] = from_float<T>(
            m[g] == kNegInf ? 0.f : a / fmaxf(l[g], 1e-20f));
      } else {
        const size_t bs = b * n_split + split;
        part_acc[bs * D + d] = a;
        if (d == 0) {
          part_m[bs] = m[g];
          part_l[bs] = l[g];
        }
      }
    }
    __syncthreads();
  }
}

// o[b] from the partial states of the ranges of row b = blockIdx.x that
// ran: the first ceil(ceil(n / 64) / tiles) of n_split, n its slot's live
// length.
template <typename T, int D>
__global__ void __launch_bounds__(merge_threads<D>())
pooled_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int L, int n_heads, int tiles, int n_split) {
  const size_t b = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= D) return;
  const int n_live = live_length(lengths, (int)(b / n_heads), L);
  const int ran = ((n_live + kKeys - 1) / kKeys + tiles - 1) / tiles;
  const float* pm = part_m + b * n_split;
  const float* pl = part_l + b * n_split;
  float mx = kNegInf;
  for (int s = 0; s < ran; ++s) mx = fmaxf(mx, pm[s]);
  float a = 0.f, sum = 0.f;
  for (int s = 0; s < ran; ++s) {
    const float wt = fast_exp2(pm[s] - mx);
    sum = fmaf(wt, pl[s], sum);
    a = fmaf(wt, part_acc[(b * n_split + s) * D + d], a);
  }
  // no range ran (n = 0) or none saw a live key: zeros
  o[b * D + d] = from_float<T>(mx == kNegInf ? 0.f : a / fmaxf(sum, 1e-20f));
}

template <typename T, int D, int kG>
cudaError_t launch_pooled(dim3 grid, const void* q, const void* k,
                          const void* v, const void* positions,
                          const void* lengths, void* o, void* part_acc,
                          void* part_m, void* part_l, int L, int G,
                          int kv_per_slot, int tiles, float scale_log2,
                          cudaStream_t stream) {
  if (tiles > Plan<T, D, kG>::kMaxTiles) return cudaErrorInvalidValue;
  const size_t bytes = Plan<T, D, kG>::bytes(tiles);
  auto kernel = pooled_split_kernel<T, D, kG>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(positions),
      static_cast<const int*>(lengths), static_cast<T*>(o),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), L, G, kv_per_slot, tiles, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// MLA's absorbed decode over a latent cache (decode_attention_mla_fwd): the
// pooled function with one KV row a slot (G = n_heads), k_eff = [ckv ‖ kr]
// (Dk = R + rope) and v_eff = ckv (Dv = R), read from the cache's ckv
// (B, L, R) and kr (B, L, rope) in place. Built for deepseek-v2's widths.
//
// What bounds it: a key's 1,152 bytes (bf16) feed 128 heads x (576 + 512)
// x 2 ≈ 278 k operations, about 242 operations a byte, just under the
// H100's 295 bf16 tensor-core operations a byte: on the tensor cores it is
// bound by the bytes of the live keys (at 67 TFLOP/s of fp32 FMAs on the
// CUDA cores it could not be). Two kernels, chosen by dtype as the prefill
// kernels choose their engines, never a retry:
// - bf16 runs on the tensor cores (mla_wgmma_kernel, below): 64 heads a
//   CTA, the wgmma M tile, with each 64-key tile of ckv ‖ kr staged once by
//   TMA for both products.
// - fp32 runs on the CUDA cores (mla_decode_kernel), since the tensor
//   cores offer fp32 products only as TF32: kMlaHeads query heads of one
//   slot over one range of `tiles` 64-key tiles a CTA, in sub-tiles of
//   kMlaKeys keys staged once in shared memory as fp32 rows of ckv ‖ kr
//   for both products (their first R columns are v_eff), with an online
//   softmax across the sub-tiles.
// Both cut the ranges from the capacity as the pooled kernel cuts them (a
// range past the slot's live length returns at once, and the ranges merge
// in pooled_merge_kernel), and both compute the same numbers: fp32 scores
// in log2 units, -1e30 for a dead position after the scaling, p = 0 for a
// key past the live length, a running max, p rounded to T before PV while
// l sums the unrounded p, acc / max(l, 1e-20).
// ---------------------------------------------------------------------------

constexpr int kMlaR = 512;      // kv_lora_rank
constexpr int kMlaRope = 64;    // qk_rope_head_dim
constexpr int kMlaDk = kMlaR + kMlaRope;
constexpr int kMlaHeads = 16;   // query heads of one CTA
constexpr int kMlaKeys = 32;    // keys of one staged sub-tile
constexpr int kMlaThreads = 256;

// Shared memory of one MLA CTA: q (kMlaHeads, Dk) and one sub-tile of keys
// (kMlaKeys rows of Dk, an odd fp32 row stride so that a column read is
// conflict-free) in fp32, p (kMlaHeads, kMlaKeys), each head's alpha of the
// sub-tile, and the heads' final m and l.
struct MlaPlan {
  static constexpr int kLd = kMlaDk + 1;
  static constexpr uint32_t kK = 4 * kMlaHeads * kMlaDk;
  static constexpr uint32_t kP = kK + 4 * kMlaKeys * kLd;
  static constexpr uint32_t kAlpha = kP + 4 * kMlaHeads * kMlaKeys;
  static constexpr uint32_t kML = kAlpha + 4 * kMlaHeads;
  static constexpr size_t kBytes = kML + 4 * 2 * kMlaHeads;
  static_assert(kMlaThreads == 16 * kMlaHeads && kMlaKeys == 32 &&
                    kMlaR == 2 * kMlaThreads,
                "thread (h, x) scores keys x and x + 16 of head h; a "
                "thread accumulates latent columns t and t + 256");
};

// One CTA: heads [h0, h0 + n_h) of slot blockIdx.x (h0 = blockIdx.z *
// kMlaHeads) over keys [t0 * 64, min((t0 + tiles) * 64, n_live)) of its
// latent cache, t0 = blockIdx.y * tiles.
template <typename T>
__global__ void __launch_bounds__(kMlaThreads)
mla_decode_kernel(const T* __restrict__ q, const T* __restrict__ ckv,
                  const T* __restrict__ kr, const int* __restrict__ positions,
                  const int* __restrict__ lengths, T* __restrict__ o,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l, int L, int H, int tiles,
                  float scale_log2) {
  using P = MlaPlan;
  constexpr int kE = 16 / (int)sizeof(T);  // elements of 16 bytes
  constexpr int kRowVecs = kMlaDk / kE;    // 16-byte vectors of a key
  constexpr int kCkvVecs = kMlaR / kE;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int slot = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int h0 = blockIdx.z * kMlaHeads;
  const int n_h = min(kMlaHeads, H - h0);
  const size_t row0 = (size_t)slot * H + h0;  // the CTA's first q / o row
  const int n_live = live_length(lengths, slot, L);
  const int t0 = split * tiles;
  if (t0 * kKeys >= n_live) {  // past the slot's live keys: nothing to read
    if (n_split == 1)  // n_live = 0 and no merge: the rows are zeros
      for (int i = tid; i < n_h * kMlaR; i += kMlaThreads)
        o[row0 * kMlaR + i] = from_float<T>(0.f);
    return;
  }
  const int key_end = min((t0 + tiles) * kKeys, n_live);
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + P::kK);
  float* ps = reinterpret_cast<float*>(smem + P::kP);
  float* alpha_s = reinterpret_cast<float*>(smem + P::kAlpha);
  float* ml_s = reinterpret_cast<float*>(smem + P::kML);
  for (int i = tid; i < kMlaHeads * kMlaDk; i += kMlaThreads)
    qs[i] = i < n_h * kMlaDk ? to_float(q[row0 * kMlaDk + i]) : 0.f;

  // scores: thread (hy, kx) takes head hy and keys kx, kx + 16 of a
  // sub-tile; the 16 threads of a head share a half-warp and its running
  // m and l. PV: thread tid takes latent columns tid and tid + 256 of
  // every head.
  const int hy = tid / 16, kx = tid % 16;
  const int* prow = positions == nullptr ? nullptr
                                         : positions + (size_t)slot * L;
  float m = kNegInf, l = 0.f;
  float acc[kMlaHeads][2];
#pragma unroll
  for (int h = 0; h < kMlaHeads; ++h) acc[h][0] = acc[h][1] = 0.f;

  for (int k0 = t0 * kKeys; k0 < key_end; k0 += kMlaKeys) {
    const int nk = min(kMlaKeys, key_end - k0);
    __syncthreads();  // q is staged; the last sub-tile's ks / ps are read
    for (int i = tid; i < nk * kRowVecs; i += kMlaThreads) {
      const int r = i / kRowVecs, c = i - r * kRowVecs;
      const size_t key = (size_t)slot * L + k0 + r;
      const T* src = c < kCkvVecs ? ckv + key * kMlaR + c * kE
                                  : kr + key * kMlaRope + (c - kCkvVecs) * kE;
      float x[kE];
      load_vec(reinterpret_cast<const uint8_t*>(src), x);
#pragma unroll
      for (int e = 0; e < kE; ++e) ks[r * P::kLd + c * kE + e] = x[e];
    }
    __syncthreads();

    const float* qr = qs + hy * kMlaDk;
    const float* ka = ks + kx * P::kLd;
    const float* kb = ks + (kx + 16) * P::kLd;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < kMlaDk; ++d) {
      const float a = qr[d];
      s0 = fmaf(a, ka[d], s0);
      s1 = fmaf(a, kb[d], s1);
    }
    // a key past the sub-tile is no key (p = 0); a live one has a position
    // >= 0; a dead one is masked to -1e30 after the scaling
    const bool in0 = kx < nk, in1 = kx + 16 < nk;
    const bool live0 = in0 && (prow == nullptr || prow[k0 + kx] >= 0);
    const bool live1 = in1 && (prow == nullptr || prow[k0 + kx + 16] >= 0);
    s0 = live0 ? s0 * scale_log2 : kNegInf;
    s1 = live1 ? s1 * scale_log2 : kNegInf;
    const float m_new = fmaxf(m, warp_max16(fmaxf(s0, s1)));
    const float alpha = fast_exp2(m - m_new);
    const float p0 = in0 ? fast_exp2(s0 - m_new) : 0.f;
    const float p1 = in1 ? fast_exp2(s1 - m_new) : 0.f;
    l = l * alpha + warp_sum16(p0 + p1);
    m = m_new;
    ps[hy * kMlaKeys + kx] = round_to<T>(p0);
    ps[hy * kMlaKeys + kx + 16] = round_to<T>(p1);
    if (kx == 0) alpha_s[hy] = alpha;
    __syncthreads();

#pragma unroll
    for (int h = 0; h < kMlaHeads; ++h) {
      acc[h][0] *= alpha_s[h];
      acc[h][1] *= alpha_s[h];
    }
    for (int r = 0; r < nk; ++r) {
      const float b0 = ks[r * P::kLd + tid];
      const float b1 = ks[r * P::kLd + tid + kMlaThreads];
#pragma unroll
      for (int h = 0; h < kMlaHeads; ++h) {
        const float p = ps[h * kMlaKeys + r];
        acc[h][0] = fmaf(p, b0, acc[h][0]);
        acc[h][1] = fmaf(p, b1, acc[h][1]);
      }
    }
  }

  if (kx == 0) {
    ml_s[hy] = m;
    ml_s[kMlaHeads + hy] = l;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kMlaHeads; ++h) {
    if (h >= n_h) break;
    const float mh = ml_s[h], lh = ml_s[kMlaHeads + h];
    const size_t b = row0 + h;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + j * kMlaThreads;
      if (n_split == 1) {  // no live key (m = -1e30): zeros
        o[b * kMlaR + d] = from_float<T>(
            mh == kNegInf ? 0.f : acc[h][j] / fmaxf(lh, 1e-20f));
      } else {
        const size_t bs = b * n_split + split;
        part_acc[bs * kMlaR + d] = acc[h][j];
        if (d == 0) {
          part_m[bs] = mh;
          part_l[bs] = lh;
        }
      }
    }
  }
}

}  // namespace split

// ---------------------------------------------------------------------------
// The bf16 latent decode on Hopper's tensor cores.
//
// One CTA takes kHeads = 64 query heads (the wgmma M tile) of one slot over
// one range of `tiles` 64-key tiles. The grid is (ceil(H / 64), ranges,
// slots), head blocks fastest, so the CTAs that read one range's keys (2 at
// G = 128) run side by side and the second read finds the keys in L2.
// - TMA. Thread 0 loads q's 64 x 576 tile once through a 3-D map over
//   (B, H, 576), so rows past H (16 or 32 heads) read as zeros, never the
//   next slot's q, and only rows below H are written. Key tiles of 64 x
//   (512 + 64) come from 3-D maps over ckv (B, L, 512) and kr (B, L, 64)
//   into a ring of kStages slots, each completing on its mbarrier; the next
//   tile is in flight while the CTA computes. Reads past L are zeros; keys
//   of a tile past the live length have their ckv rows zeroed in shared
//   memory, so that p = 0 never meets a stale NaN there.
// - Layout. Every tile is 64-row panels of 64 bf16 columns under the
//   128-byte swizzle: q and the key tiles 9 panels each (73,728 bytes; kr
//   is the last panel), P one. Each TMA box row is a whole 128-byte line;
//   the prefill engine's 64-byte panels (which serve D = 96 and 160) take
//   twice the boxes and read slower here at every shape measured.
// - Two consumer warpgroups. S = q [ckv ‖ kr]^T runs as wgmma m64n32k16,
//   36 k16 steps, warpgroup w taking keys [32 w, 32 w + 32) of the tile (K
//   K-major); their row maxima meet in shared memory, so both hold the same
//   running max and rescale; each writes its p, rounded to bf16, into
//   columns [32 w, 32 w + 32) of P. O += P ckv runs as wgmma m64n256k16
//   with P K-major and the staged tile's 8 ckv panels as B read MN-major,
//   warpgroup w taking latent columns [256 w, 256 w + 256) (128 fp32
//   accumulators a thread): one staged tile feeds both products. l sums
//   are added across the two at the end.
// ---------------------------------------------------------------------------

namespace mla {

constexpr int kR = 512;                         // kv_lora_rank
constexpr int kRope = 64;                       // qk_rope_head_dim
constexpr int kHeads = 64;                      // query heads of one CTA
constexpr int kKeys = 64;                       // keys of one tile
constexpr int kStages = 2;                      // key tiles in flight
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kPanelCols = 64;                  // bf16 columns of a panel
constexpr int kPanels = (kR + kRope) / kPanelCols;  // 9 of q and a tile
constexpr int kVPanels = kR / kPanelCols;       // ckv's 8 of them
constexpr int kPanelBytes = kKeys * 2 * kPanelCols;  // 8192: 64 x 128 B
constexpr int kTile = kPanels * kPanelBytes;    // 73,728

// Byte offsets in shared memory from a 1024-byte aligned base: q, the
// kStages key tiles, P (one panel), the mbarriers (q's, then one a key
// slot), the warpgroups' row maxima and their row sums (2 x 64 fp32 each).
struct Layout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kTile;
  static constexpr uint32_t kP = kK + kStages * kTile;
  static constexpr uint32_t kBars = kP + kPanelBytes;
  static constexpr uint32_t kMax = kBars + 8 * (1 + kStages);
  static constexpr uint32_t kSum = kMax + 4 * 2 * kHeads;
  static constexpr uint32_t kEnd = kSum + 4 * 2 * kHeads;
  static constexpr size_t kBytes = 1024 + kEnd;  // + the base's alignment
  static_assert(kHeads == kKeys && kKeys == split::kKeys,
                "one panel shape for q, keys and P; the pooled kernel's "
                "tiles");
  static_assert(kBytes <= 232448, "one CTA's shared memory on an H100");
};

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A K-major and B MN-major (the
// transpose bit) in shared memory.
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Orders this thread's generic-proxy shared-memory writes before the async
// proxy's reads of them (wgmma operands).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// sm90 matrix descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (q and P as A, the keys as B of S): k16 step kk of a
// tile of panels, panel kk / 4 and 32 bytes a step inside its 128-byte
// rows; 8-row groups 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16,
                    1024);
}

// MN-major operand (ckv as B of O += P ckv): keys [16 kk, 16 kk + 16) of
// a tile. Along N the 64-column panels are kPanelBytes apart (leading
// offset), along K the 8-key groups 1024 bytes (stride offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kPanelBytes, 1024);
}

// Byte offset of the bf16 pair at (row r, columns c and c + 1), c even, in
// a 64 x 64 panel under the 128-byte swizzle, as TMA lays it out: the
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// One CTA: heads [h0, h0 + n_h) of slot blockIdx.z (h0 = blockIdx.x * 64)
// over the tiles [t0, t0 + n) of its latent cache, t0 = blockIdx.y *
// tiles, keys cut at n_live.
__global__ void __launch_bounds__(kThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap rmap,
                 const int* __restrict__ positions,
                 const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ part_acc,
                 float* __restrict__ part_m, float* __restrict__ part_l, int L,
                 int H, int tiles, float scale_log2) {
  using Ly = Layout;
  extern __shared__ __align__(1024) uint8_t mla_smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int h0 = blockIdx.x * kHeads, split = blockIdx.y, slot = blockIdx.z;
  const int n_split = gridDim.y;
  const int n_h = min(kHeads, H - h0);
  const size_t row0 = (size_t)slot * H + h0;  // the CTA's first q / o row
  const int n_live = split::live_length(lengths, slot, L);
  const int t0 = split * tiles;
  if (t0 * kKeys >= n_live) {  // past the slot's live keys: nothing to read
    if (n_split == 1)  // n_live = 0 and no merge: the rows are zeros
      for (int i = tid; i < n_h * kR; i += kThreads)
        o[row0 * kR + i] = __float2bfloat16(0.f);
    return;
  }
  const int n = min(tiles, (n_live + kKeys - 1) / kKeys - t0);
  const int key_end = min((t0 + n) * kKeys, n_live);

  const uint32_t raw = smem_u32(mla_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  uint8_t* sm = mla_smem + pad;
  float* red_max = reinterpret_cast<float*>(sm + Ly::kMax);
  float* red_sum = reinterpret_cast<float*>(sm + Ly::kSum);
  auto bar = [&](int i) { return base + Ly::kBars + 8 * i; };  // 0: q's
  auto slot_of = [&](int j) { return Ly::kK + (j % kStages) * kTile; };
  auto load_tile = [&](int j) {  // tile t0 + j of the range into its slot
    const uint32_t dst = base + slot_of(j), mb = bar(1 + j % kStages);
    const int key = (t0 + j) * kKeys;
    mbar_expect_tx(mb, kTile);
#pragma unroll
    for (int p = 0; p < kVPanels; ++p)
      wgmma::tma_load_3d(dst + p * kPanelBytes, &cmap, mb, kPanelCols * p,
                         key, slot);
#pragma unroll
    for (int p = kVPanels; p < kPanels; ++p)
      wgmma::tma_load_3d(dst + p * kPanelBytes, &rmap, mb,
                         kPanelCols * (p - kVPanels), key, slot);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised
  if (tid == 0) {
    mbar_expect_tx(bar(0), kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      wgmma::tma_load_3d(base + Ly::kQ + p * kPanelBytes, &qmap, bar(0),
                         kPanelCols * p, h0, slot);
    for (int j = 0; j < kStages && j < n; ++j) load_tile(j);
  }

  // this thread's rows r0 and r0 + 8 of the 64 heads (both warpgroups hold
  // the same rows) and, of each tile, the keys 32 wg + 8 c + 2 (lane % 4) +
  // e, c < 4, e < 2: register 4 c + 2 r + e of s (row r0 + 8 r)
  const int r0 = 16 * warp + lane / 4;
  const int* prow = positions == nullptr ? nullptr
                                         : positions + (size_t)slot * L;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  mbar_wait(bar(0), 0);

  for (int j = 0; j < n; ++j) {
    const int kv0 = (t0 + j) * kKeys;
    const uint32_t ks = base + slot_of(j);
    // bit 2 c + e of `in`: the key is below the range's end (else p = 0);
    // of `live`: it is in and its position is >= 0 (else -1e30)
    uint32_t in = 0, live = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kv0 + 32 * wg + 8 * c + 2 * (lane & 3) + e;
        if (key < key_end) {
          in |= 1u << (2 * c + e);
          if (prow == nullptr || prow[key] >= 0) live |= 1u << (2 * c + e);
        }
      }
    mbar_wait(bar(1 + j % kStages), (j / kStages) & 1);
    const int nk = key_end - kv0;  // keys of this tile in the range
    if (nk < kKeys) {  // the range's last tile: zero ckv's rows >= nk
      const int per_panel = (kKeys - nk) * 8;  // 16-byte chunks
      for (int i = tid; i < kVPanels * per_panel; i += kThreads) {
        const int p = i / per_panel;
        *reinterpret_cast<uint4*>(sm + slot_of(j) + p * kPanelBytes +
                                  nk * 128 + (i - p * per_panel) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_async_shared();
      __syncthreads();  // the zeros are in place for both products
    }

    // S = q k^T over this warpgroup's 32 keys
    wgmma::fence_regs(s);
    wgmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPanels * 4; ++kk)
      wgmma_ss_n32(s, kmajor_desc(base + Ly::kQ, kk),
                   kmajor_desc(ks + 32 * 128 * wg, kk), kk > 0);
    wgmma::wgmma_commit();
    wgmma::wgmma_wait_all();
    wgmma::fence_regs(s);

    // the online softmax: log2 units, -1e30 for a dead key, the running max
    // over both warpgroups' keys
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int bit = 2 * (i >> 2) + (i & 1);
      s[i] = (live >> bit) & 1 ? s[i] * scale_log2 : kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row share a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((lane & 3) == 0) red_max[wg * kHeads + r0 + 8 * r] = mx[r];
    }
    __syncthreads();  // both warpgroups' maxima are in place
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new =
          fmaxf(m[r], fmaxf(red_max[r0 + 8 * r],
                            red_max[kHeads + r0 + 8 * r]));
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p = exp2(s - m), 0 past the range; l sums the unrounded p, P holds
    // it rounded to bf16 (keys 32 wg .. 32 wg + 31 of P's panel)
    uint8_t* pp = sm + Ly::kP;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * c + 2 * r;
        const float p0 =
            (in >> (2 * c)) & 1 ? fast_exp2(s[i] - m[r]) : 0.f;
        const float p1 =
            (in >> (2 * c + 1)) & 1 ? fast_exp2(s[i + 1] - m[r]) : 0.f;
        l[r] += p0 + p1;
        *reinterpret_cast<uint32_t*>(
            pp + sw128_offset(r0 + 8 * r,
                              32 * wg + 8 * c + 2 * (lane & 3))) =
            wgmma::pack_bf16(p0, p1);
      }
    fence_async_shared();
    // alpha is 1 once a row's max has settled: skip the rescale when it is
    // 1 for all the warp's rows (bit-identical)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    __syncthreads();  // P is whole

    // O[:, 256 wg ..] += P ckv[:, 256 wg ..]
    wgmma::fence_regs(acc);
    wgmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_ss_n256_tb(acc, kmajor_desc(base + Ly::kP, kk),
                       mnmajor_desc(ks + 4 * kPanelBytes * wg, kk));
    wgmma::wgmma_commit();
    wgmma::wgmma_wait_all();
    wgmma::fence_regs(acc);

    __syncthreads();  // both warpgroups are done with this slot and P
    if (tid == 0 && j + kStages < n) load_tile(j + kStages);
  }

  // l: the quad's lanes, then the two warpgroups' keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if ((lane & 3) == 0) red_sum[wg * kHeads + r0 + 8 * r] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n_h) continue;
    const float lr = red_sum[row] + red_sum[kHeads + row];
    const size_t b = row0 + row;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int d = 256 * wg + 8 * c + 2 * (lane & 3);
      const float a0 = acc[4 * c + 2 * r], a1 = acc[4 * c + 2 * r + 1];
      if (n_split == 1) {  // no live key (m = -1e30): zeros
        const bool none = m[r] == kNegInf;
        const float den = fmaxf(lr, 1e-20f);
        *reinterpret_cast<__nv_bfloat162*>(o + b * kR + d) =
            __floats2bfloat162_rn(none ? 0.f : a0 / den,
                                  none ? 0.f : a1 / den);
      } else {
        const size_t bs = b * n_split + split;
        *reinterpret_cast<float2*>(part_acc + bs * kR + d) =
            make_float2(a0, a1);
      }
    }
    if (n_split > 1 && wg == 0 && (lane & 3) == 0) {
      part_m[b * n_split + split] = m[r];
      part_l[b * n_split + split] = lr;
    }
  }
}

// A contiguous (rows, seq, D) bf16 tensor as a 3-D map with boxes of one
// panel (64 columns x 64 rows) under the 128-byte swizzle; reads past seq
// are zeros. The prefill engine's make_map with 128-byte boxes: TMA needs
// a 16-byte aligned base and row stride (2 D bytes).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows,
                            int seq, int D) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorMisalignedAddress;
  wgmma::EncodeTiled encode;
  cudaError_t e = wgmma::encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)seq,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)seq * D * 2};
  const cuuint32_t box[3] = {kPanelCols, kKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace mla

// The fp32 latent decode on the CUDA cores (instantiated for float only).
template <typename T> struct MlaLaunch {
  static cudaError_t run(const void* q, const void* ckv, const void* kr,
                         const void* positions, const void* lengths, void* o,
                         void* part_acc, void* part_m, void* part_l, int B,
                         int H, int L, int tiles, float scale,
                         cudaStream_t stream) {
    const int n_tiles = (L + split::kKeys - 1) / split::kKeys;
    if (B < 1 || H < 1 || tiles < 1 || tiles > n_tiles)
      return cudaErrorInvalidValue;
    const int n_split = (n_tiles + tiles - 1) / tiles;
    const size_t bytes = split::MlaPlan::kBytes;
    auto kernel = split::mla_decode_kernel<T>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(B, n_split,
                    (H + split::kMlaHeads - 1) / split::kMlaHeads);
    kernel<<<grid, split::kMlaThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ckv),
        static_cast<const T*>(kr), static_cast<const int*>(positions),
        static_cast<const int*>(lengths), static_cast<T*>(o),
        static_cast<float*>(part_acc), static_cast<float*>(part_m),
        static_cast<float*>(part_l), L, H, tiles, scale * kLog2e);
    e = cudaGetLastError();
    if (e != cudaSuccess || n_split == 1) return e;
    split::pooled_merge_kernel<T, split::kMlaR>
        <<<B * H, split::merge_threads<split::kMlaR>(), 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const int*>(lengths), static_cast<T*>(o), L, H, tiles,
        n_split);
    return cudaGetLastError();
  }
};

// The bf16 latent decode: mla_wgmma_kernel over ranges of `tiles` tiles,
// merged as MlaLaunch merges them. A launch the card refuses (its shared
// memory, its grid) returns the error; nothing falls back to the CUDA cores.
struct MlaWgmmaLaunch {
  static cudaError_t run(const void* q, const void* ckv, const void* kr,
                         const void* positions, const void* lengths, void* o,
                         void* part_acc, void* part_m, void* part_l, int B,
                         int H, int L, int tiles, float scale,
                         cudaStream_t stream) {
    const int n_tiles = (L + mla::kKeys - 1) / mla::kKeys;
    if (B < 1 || H < 1 || tiles < 1 || tiles > n_tiles)
      return cudaErrorInvalidValue;
    const int n_split = (n_tiles + tiles - 1) / tiles;
    wgmma::Maps maps;  // q (B, H, R + rope), ckv (B, L, R), kr (B, L, rope)
    cudaError_t e = mla::make_map(&maps.q, q, B, H, mla::kR + mla::kRope);
    if (e == cudaSuccess) e = mla::make_map(&maps.k, ckv, B, L, mla::kR);
    if (e == cudaSuccess) e = mla::make_map(&maps.v, kr, B, L, mla::kRope);
    if (e != cudaSuccess) return e;
    const size_t bytes = mla::Layout::kBytes;
    auto kernel = mla::mla_wgmma_kernel;
    e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((H + mla::kHeads - 1) / mla::kHeads, n_split, B);
    kernel<<<grid, mla::kThreads, bytes, stream>>>(
        maps.q, maps.k, maps.v, static_cast<const int*>(positions),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(part_acc), static_cast<float*>(part_m),
        static_cast<float*>(part_l), L, H, tiles, scale * kLog2e);
    e = cudaGetLastError();
    if (e != cudaSuccess || n_split == 1) return e;
    split::pooled_merge_kernel<__nv_bfloat16, mla::kR>
        <<<B * H, split::merge_threads<mla::kR>(), 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(o), L,
        H, tiles, n_split);
    return cudaGetLastError();
  }
};

template <typename T, int D> struct PooledLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* positions, const void* lengths, void* o,
                         void* part_acc, void* part_m, void* part_l, int BH,
                         int BHkv, int L, int n_heads, int tiles,
                         float scale, cudaStream_t stream) {
    if (BH % BHkv != 0 || n_heads < 1 || BH % n_heads != 0)
      return cudaErrorInvalidValue;
    const int G = BH / BHkv;
    if (n_heads % G != 0) return cudaErrorInvalidValue;
    const int n_tiles = (L + split::kKeys - 1) / split::kKeys;
    if (tiles < 1 || tiles > n_tiles) return cudaErrorInvalidValue;
    const int n_split = (n_tiles + tiles - 1) / tiles;
    const float scale_log2 = scale * kLog2e;
    const int kG = G == 1 ? 1 : split::kMaxG;
    const dim3 grid(BHkv, n_split, (G + kG - 1) / kG);
    const int kv_per_slot = n_heads / G;
    cudaError_t e =
        G == 1 ? split::launch_pooled<T, D, 1>(
                     grid, q, k, v, positions, lengths, o, part_acc, part_m,
                     part_l, L, G, kv_per_slot, tiles, scale_log2, stream)
               : split::launch_pooled<T, D, split::kMaxG>(
                     grid, q, k, v, positions, lengths, o, part_acc, part_m,
                     part_l, L, G, kv_per_slot, tiles, scale_log2, stream);
    if (e != cudaSuccess || n_split == 1) return e;
    split::pooled_merge_kernel<T, D>
        <<<BH, split::merge_threads<D>(), 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const int*>(lengths), static_cast<T*>(o), L, n_heads,
        tiles, n_split);
    return cudaGetLastError();
  }
};

}  // namespace flux

// q (BH, 1, Dk), k (BHkv, L, Dk), v (BHkv, L, Dv), positions (B, L) int32
// or null, lengths (B,) int32, o (BH, 1, Dv), B = BH / n_heads; k and v
// 16-byte aligned. tiles in [1, ceil(L / 64)] tiles a range; with
// R = ceil(ceil(L / 64) / tiles) > 1 the fp32 scratch part_acc (BH, R, Dv),
// part_m and part_l (BH, R). Built for Dk = Dv only; another pair returns
// cudaErrorInvalidValue. Returns the first cudaError_t code of the two
// launches.
extern "C" int decode_attention_pooled_fwd(const void* q, const void* k,
                                           const void* v,
                                           const void* positions,
                                           const void* lengths, void* o,
                                           void* part_acc, void* part_m,
                                           void* part_l, int BH, int BHkv,
                                           int L, int Dk, int Dv,
                                           int n_heads, int dtype, int tiles,
                                           float scale, void* stream) {
  if (Dk != Dv) return (int)cudaErrorInvalidValue;
  return flux::dispatch<flux::PooledLaunch>(
      dtype, Dk, q, k, v, positions, lengths, o, part_acc, part_m, part_l,
      BH, BHkv, L, n_heads, tiles, scale, static_cast<cudaStream_t>(stream));
}

// q (B·H, 1, R + rope), ckv (B, L, R), kr (B, L, rope), positions (B, L)
// int32 or null, lengths (B,) int32, o (B·H, 1, R): MLA's absorbed decode,
// one KV row a slot, at the explicit scale (nope + rope) ** -0.5; ckv and kr
// 16-byte aligned, and q too in bf16 (its TMA map). Built for (R, rope) =
// (512, 64); another pair returns cudaErrorInvalidValue. bf16 runs
// mla_wgmma_kernel (tensor cores), fp32 mla_decode_kernel (CUDA cores).
// tiles and the scratch as decode_attention_pooled_fwd takes them, with
// Dv = R. Returns the first cudaError_t code of the two launches.
extern "C" int decode_attention_mla_fwd(const void* q, const void* ckv,
                                        const void* kr, const void* positions,
                                        const void* lengths, void* o,
                                        void* part_acc, void* part_m,
                                        void* part_l, int B, int n_heads,
                                        int L, int R, int rope, int dtype,
                                        int tiles, float scale,
                                        void* stream) {
  cudaError_t e = cudaErrorInvalidValue;
  if (R == flux::split::kMlaR && rope == flux::split::kMlaRope) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == flux::kF32)
      e = flux::MlaLaunch<float>::run(q, ckv, kr, positions, lengths, o,
                                      part_acc, part_m, part_l, B, n_heads,
                                      L, tiles, scale, st);
    if (dtype == flux::kBF16)
      e = flux::MlaWgmmaLaunch::run(q, ckv, kr, positions, lengths, o,
                                    part_acc, part_m, part_l, B, n_heads, L,
                                    tiles, scale, st);
  }
  if (e != cudaSuccess) cudaGetLastError();  // the next call reports its own
  return (int)e;
}

// Dynamic shared memory one CTA of the latent decode asks for: the bf16
// tensor-core kernel's (dtype 1) or the fp32 CUDA-core kernel's (0).
extern "C" int flux_mla_smem_bytes(int dtype) {
  return dtype == flux::kBF16 ? (int)flux::mla::Layout::kBytes
                              : (int)flux::split::MlaPlan::kBytes;
}
