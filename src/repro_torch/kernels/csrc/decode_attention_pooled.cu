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
  if (tiles > max_tiles<kG>()) return cudaErrorInvalidValue;
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
// FMAs, about 240 operations a byte, so at full width it is bound by
// operations, near the tensor cores' balance point and far above the CUDA
// cores'. This first kernel runs them on the CUDA cores in fp32, simple and
// exact to the pooled kernel's rounding; moving them onto wgmma is speed
// work for later. Each CTA takes kMlaHeads query heads of one slot over one
// range of `tiles` 64-key tiles, cut from the capacity as the pooled kernel
// cuts them (a range past the slot's live length returns at once, and the
// ranges merge in pooled_merge_kernel). It walks its range in sub-tiles of
// kMlaKeys keys: each is staged once in shared memory as fp32 rows of
// ckv ‖ kr and serves both products (its first R columns are v_eff), with
// an online softmax across the sub-tiles (log2 units, the -1e30 mask, p
// rounded to T while l sums the unrounded p, as the prefill engine keeps
// its running max). The heads' 8 CTAs of a range re-read its keys from L2.
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
// 16-byte aligned. Built for (R, rope) = (512, 64); another pair returns
// cudaErrorInvalidValue. tiles and the scratch as decode_attention_pooled_fwd
// takes them, with Dv = R. Returns the first cudaError_t code of the two
// launches.
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
      e = flux::MlaLaunch<__nv_bfloat16>::run(q, ckv, kr, positions,
                                              lengths, o, part_acc, part_m,
                                              part_l, B, n_heads, L, tiles,
                                              scale, st);
  }
  if (e != cudaSuccess) cudaGetLastError();  // the next call reports its own
  return (int)e;
}
