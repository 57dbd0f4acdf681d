// One-token decode attention over a KV cache, for Hopper (sm_90a):
// split-KV with a log-sum-exp merge.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_bh, body _kernel). Same function: the query of row b
// attends the cache of key row b / G at the slots whose position p has
// p >= 0 and p <= cur_pos (-1 marks an empty ring slot), with the online
// softmax over key tiles. One positions vector (L,) is shared by all rows,
// so one kernel serves the full cache (positions = arange) and the
// sink + local ring (positions = the ring's own) of the serving decode.
//
// What bounds it: the bytes of K and V it reads (one query token does two
// FMAs per cached element), so the least time is the cache bytes over the
// memory rate, and the design is about bytes in flight. The TPU kernel
// walks a row's key blocks along a sequential grid axis; here the keys of
// a row are cut into n_split contiguous ranges of whole 64-key tiles (split
// s takes tiles [s n / n_split, (s + 1) n / n_split) of the n = ceil(L / 64),
// so none is empty and their sizes differ by at most one), one CTA each,
// so that a batch of few rows still puts a CTA on every multiprocessor:
// - Grid (BHkv, n_split, ceil(G / kG)). A CTA serves up to kG query rows
//   of one KV row, so K and V are read once for all of them.
// - Loads. The CTA's walk is its K tiles, then its V tiles; each tile is
//   one contiguous run of rows, copied by the TMA unit (one 1-D bulk copy
//   issued by one thread) in the operands' own dtype into a ring of
//   kStages slots, each completing on its own mbarrier, so the next tiles
//   land while this one is computed; the V loads start during the K pass.
//   Every mbarrier wait traps after 2^24 polls, so a load that never lands
//   ends the launch with an error instead of hanging it. The split's
//   positions come in by cp.async at the start.
// - Pass K: lanes 2 i and 2 i + 1 of warp w score key 16 w + i of a tile,
//   16 bytes a load, and write the raw dot products into shared memory.
//   Then one softmax over the split's scores, in fp32 with the TPU
//   numerics: scores in log2 units (scale * log2 e folded into one
//   multiply, exp2 on the SFU), masked keys at -1e30 after the scaling (so
//   -1e30 stays -1e30), p = exp2(s - m) rounded to the operand dtype while
//   l sums the unrounded p. Pass V: each thread owns one 16-byte vector of
//   the row and every kGroups-th key of a tile; the groups' sums meet in
//   shared memory at the end. No chain of shuffles runs per tile.
// - Merge. The CTA writes the output (n_split = 1) or its split's fp32
//   (acc, m, l) into scratch the caller allocates; a second kernel of the
//   same C entry computes o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-20)
//   with w_s = exp2(m_s - max_s m_s). A split whose keys are all masked has
//   m_s = -1e30 and p = 1 on each of its keys (as in the TPU kernel) and is
//   erased by w_s = 0 as soon as any split has a live key; a row with no
//   live key at all weighs every key 1, the mean of V that the plain
//   version's dense softmax gives. Keys past L count for nothing.
// The tile plan, loads and reductions: decode_split.cuh, shared with the
// slot pool's decode kernel (decode_attention_pooled.cu).
#include "decode_split.cuh"

namespace flux {
namespace split {

// One CTA: the keys of tiles [t0, t0 + n) of KV row blockIdx.x for query
// rows b = blockIdx.x * G + g0 + g (g < n_g). Its walk is 2 n chunks:
// K tile j for chunk j < n, V tile j - n for chunk j >= n.
template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ positions,
                    T* __restrict__ o, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int L, int G, int cur_pos, float scale_log2) {
  using P = Plan<T, D, kG>;
  constexpr int kE = P::kE, kStages = P::kStages;
  constexpr int kHalf = P::kVecs / 2;  // vectors of a row in one lane
  constexpr size_t kRow = (size_t)D * sizeof(T);
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_row = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int g0 = blockIdx.z * kG;
  const int n_g = min(kG, G - g0);
  const int n_all = (L + kKeys - 1) / kKeys;
  const int t0 = split * n_all / n_split;
  const int n = (split + 1) * n_all / n_split - t0;  // >= 1
  const int key_first = t0 * kKeys;
  const int n_keys = min((t0 + n) * kKeys, L) - key_first;
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
  for (int i = tid; i < n_keys; i += kThreads)
    cp_async4(smem_u32(pos_s + i), positions + key_first + i);
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
          const bool live = p >= 0 && p <= cur_pos;
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
      if (n_split == 1) {
        o[b * D + d] = from_float<T>(a / fmaxf(l[g], 1e-20f));
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

// o[b] from the n_split partial states of row b = blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_m,
                    const float* __restrict__ part_l, T* __restrict__ o,
                    int n_split) {
  const size_t b = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* pm = part_m + b * n_split;
  const float* pl = part_l + b * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float a = 0.f, sum = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float wt = fast_exp2(pm[s] - mx);
    sum = fmaf(wt, pl[s], sum);
    a = fmaf(wt, part_acc[(b * n_split + s) * D + d], a);
  }
  o[b * D + d] = from_float<T>(a / fmaxf(sum, 1e-20f));
}

template <typename T, int D, int kG>
cudaError_t launch_split(dim3 grid, int tiles, const void* q, const void* k,
                         const void* v, const void* positions, void* o,
                         void* part_acc, void* part_m, void* part_l, int L,
                         int G, int cur_pos, float scale_log2,
                         cudaStream_t stream) {
  if (tiles > max_tiles<kG>()) return cudaErrorInvalidValue;
  const size_t bytes = Plan<T, D, kG>::bytes(tiles);
  auto kernel = decode_split_kernel<T, D, kG>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(positions),
      static_cast<T*>(o), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), L, G,
      cur_pos, scale_log2);
  return cudaGetLastError();
}

}  // namespace split

template <typename T, int D> struct DecodeLaunch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* positions, void* o, void* part_acc,
                         void* part_m, void* part_l, int BH, int BHkv, int L,
                         int n_split, int cur_pos, float scale,
                         cudaStream_t stream) {
    const int G = BH / BHkv;
    const int n_tiles = (L + split::kKeys - 1) / split::kKeys;
    if (n_split < 1 || n_split > n_tiles) return cudaErrorInvalidValue;
    const int tiles = (n_tiles + n_split - 1) / n_split;  // the longest
    const float scale_log2 = scale * kLog2e;
    const int kG = G == 1 ? 1 : split::kMaxG;
    const dim3 grid(BHkv, n_split, (G + kG - 1) / kG);
    cudaError_t e =
        G == 1 ? split::launch_split<T, D, 1>(
                     grid, tiles, q, k, v, positions, o, part_acc, part_m,
                     part_l, L, G, cur_pos, scale_log2, stream)
               : split::launch_split<T, D, split::kMaxG>(
                     grid, tiles, q, k, v, positions, o, part_acc, part_m,
                     part_l, L, G, cur_pos, scale_log2, stream);
    if (e != cudaSuccess || n_split == 1) return e;
    split::decode_merge_kernel<T, D><<<BH, split::kThreads, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<T*>(o), n_split);
    return cudaGetLastError();
  }
};

}  // namespace flux

// q (BH, 1, D), k / v (BHkv, L, D), positions (L,) int32, o (BH, 1, D);
// k and v 16-byte aligned. n_split in [1, ceil(L / 64)] key ranges; for
// n_split > 1 the fp32 scratch part_acc (BH, n_split, D), part_m and
// part_l (BH, n_split).
// Returns the first cudaError_t code of the two launches.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* positions,
                                    void* o, void* part_acc, void* part_m,
                                    void* part_l, int BH, int BHkv, int L,
                                    int D, int dtype, int n_split,
                                    int cur_pos, float scale, void* stream) {
  return flux::dispatch<flux::DecodeLaunch>(
      dtype, D, q, k, v, positions, o, part_acc, part_m, part_l, BH, BHkv,
      L, n_split, cur_pos, scale, static_cast<cudaStream_t>(stream));
}
