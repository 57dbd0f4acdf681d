// The attention backward's fp32 kernels on the CUDA cores (dq_kernel,
// dkdv_kernel and their launch), shared by attention_backward.cu (flash
// and streaming) and block_sparse_backward.cu (block-sparse): the policy
// (backward_wgmma.cuh) gives the mask and the walks.
//
// Two kernels, one after the other on the caller's stream:
// 1. dq_kernel: one CTA per (query head, 64 query rows). A first pass over
//    the visible key tiles recomputes each row's max m_i and sum l_i (the
//    forward kernels write neither); a second accumulates dQ in registers
//    as scale (A - D_i B) (see the kernel) and D_i = sum_j round(p_ij) /
//    l_i dP_ij, the plain version's dO_i . O_i with O from the same
//    rounded p. It writes m, l and D to `stats` (3 x BH x Sq floats).
// 2. dkdv_kernel: one CTA per (KV head, 64 keys) keeps dK and dV in
//    registers and walks the policy's (query head, query tile) steps: for
//    flash and streaming, for each of the G query heads of its KV head,
//    the query tiles that can see its keys (every later query for a sink
//    key, queries [c, c + local) for a window key); for block-sparse, the
//    (head, tile) pairs whose selection names its keys' tile. The G heads
//    are summed in registers: deterministic, no atomics.
//
// Q and K rows are Dk wide, V, dO and dV rows Dv: S and dQ reduce over
// Dk, dP over Dv. fp32 arithmetic on the CUDA cores; operands are staged in
// shared memory with an odd row stride (conflict-free column reads). A row
// with no visible key gives no gradient (the plain version's dense softmax
// would spread dV evenly over its masked keys); no training call has one
// (Sq <= Skv, q_offset >= 0, causal).
//
// What bounds it: 2·(3·Dk + 2·Dv) operations per visible (query, key) pair
// (this kernel runs S three times, dP twice, and dQ as two products)
// against the bytes of q, k, v, dO, dq, dk and dv; at training shapes
// (4096 tokens, D = 96) the operations, by far. fp32 FMAs on the CUDA
// cores reach a small share of the fp32 rate.
#pragma once

#include "attention_common.cuh"
#include "backward_wgmma.cuh"

namespace flux {
namespace bwd {

constexpr int kRows = 64;  // rows (queries in dq_kernel, keys in dkdv_kernel)
                           // a CTA owns

// The tile of the other operand a step walks: 64, or 32 from Dk + Dv = 384
// (D = 256) so that one CTA's shared memory fits the 227 KB of an H100
// ((192, 128) fits at 64: 198,912 bytes for dkdv).
template <int Dk, int Dv> struct Tiles {
  static constexpr int kStep = Dk + Dv > 320 ? 32 : 64;
  static constexpr int kLd = Dk + 1;
  static constexpr int kVLd = Dv + 1;
  static constexpr int kSLd = kStep + 1;
  static constexpr int kCols = Dk / 16;
  static constexpr int kVCols = Dv / 16;
  static constexpr int kJ = kStep / 16;
  static constexpr int kDMax = Dk > Dv ? Dk : Dv;
  static constexpr size_t kDqBytes =
      sizeof(float) * ((size_t)(kRows + kStep) * (kLd + kVLd) +
                       (size_t)2 * kRows * kSLd);
  static constexpr size_t kDkdvBytes =
      sizeof(float) * ((size_t)(kRows + kStep) * (kLd + kVLd) +
                       (size_t)2 * kRows * kSLd + 3 * kStep);
  static_assert(kDqBytes <= 232448 && kDkdvBytes <= 232448,
                "one CTA's shared memory on an H100");
};

// Rows [row0, row0 + n_rows) of a row-major (n, D) matrix into a staged
// tile of row stride Ld; rows at or past n read as zeros.
template <typename T, int D, int Ld>
__device__ void load_rows(float* dst, const T* src, int row0, int n_rows,
                          int n) {
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int g = row0 + r;
    dst[r * Ld + c] = g < n ? to_float(src[(size_t)g * D + c]) : 0.f;
  }
}

// dQ and the row statistics. Grid (ceil(Sq / 64), BH); the heaviest query
// tiles (the last, under a causal mask) are scheduled first. Pass 1 finds
// each row's m and l; pass 2 accumulates, per row, A = sum_j P_ij dP_ij k_j,
// B = sum_j P_ij k_j and D = sum_j round(p_ij) / l_i dP_ij, and
// dQ = scale (A - D B): the plain version's sum_j P_ij (dP_ij - D_i) k_j,
// with D_i formed from the same rounded p as its O (so a row whose true
// gradient cancels to 0, the first query of a causal row, gets 0).
template <typename T, int Dk, int Dv, class Policy>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ stats, int BH, int Sq,
          int Skv, int G, float scale, Policy pol) {
  using Ti = Tiles<Dk, Dv>;
  constexpr int S = Ti::kStep, Ld = Ti::kLd, VLd = Ti::kVLd, SLd = Ti::kSLd;
  constexpr int NJ = Ti::kJ, NC = Ti::kCols;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kRows * Ld;
  float* ks = dos + kRows * VLd;
  float* vs = ks + S * Ld;
  float* pds = vs + S * VLd;   // P dP, (64, S)
  float* pss = pds + kRows * SLd;  // P, (64, S)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const T* kb = k + (size_t)(bh / G) * Skv * Dk;
  const T* vb = v + (size_t)(bh / G) * Skv * Dv;
  load_rows<T, Dk, Ld>(qs, q + (size_t)bh * Sq * Dk, row0, kRows, Sq);
  load_rows<T, Dv, VLd>(dos, dout + (size_t)bh * Sq * Dv, row0, kRows, Sq);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int a1, b0, b1;
  pol.key_tiles(bh, row0, min(row0 + kRows, Sq) - 1, Skv, S, a1, b0, b1);
  const int n_walk = a1 + max(b1 - b0, 0);

  // pass 1: each row's max and sum over its visible keys
  for (int w = 0; w < n_walk; ++w) {
    const int kv0 = pol.key_step(bh, row0, w, a1, b0) * S;
    __syncthreads();
    load_rows<T, Dk, Ld>(ks, kb, kv0, S, Skv);
    __syncthreads();
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dk; ++d) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * Ld + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = ks[(tx + 16 * j) * Ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      bool live[NJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = kv0 + tx + 16 * j;
        live[j] = r < Sq && key < Skv && pol.visible(r, key);
        s[i][j] *= scale;
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max16(mx);  // the 16 threads of row ty + 16 i share a warp
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (live[j]) rs += expf(s[i][j] - m_new);
      rs = warp_sum16(rs);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
  float il[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    il[i] = 1.f / fmaxf(l[i], 1e-20f);
    dsum[i] = 0.f;
  }

  // pass 2: A += (P dP) K, B += P K, D += round(p) / l dP
  float acc[4][NC], accb[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = accb[i][c] = 0.f;
  for (int w = 0; w < n_walk; ++w) {
    const int kv0 = pol.key_step(bh, row0, w, a1, b0) * S;
    __syncthreads();  // the previous tile's reads of ks / vs / pds / pss
    load_rows<T, Dk, Ld>(ks, kb, kv0, S, Skv);
    load_rows<T, Dv, VLd>(vs, vb, kv0, S, Skv);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    // S over Dk and dP over Dv columns, in one loop (the guards fold away
    // at Dk = Dv)
#pragma unroll 2
    for (int d = 0; d < Ti::kDMax; ++d) {
      float a[4], ao[4], b[NJ], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = d < Dk ? qs[(ty + 16 * i) * Ld + d] : 0.f;
        ao[i] = d < Dv ? dos[(ty + 16 * i) * VLd + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        b[j] = d < Dk ? ks[(tx + 16 * j) * Ld + d] : 0.f;
        bv[j] = d < Dv ? vs[(tx + 16 * j) * VLd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = kv0 + tx + 16 * j;
        const bool live = r < Sq && key < Skv && pol.visible(r, key);
        const float e = live ? expf(s[i][j] * scale - m[i]) : 0.f;
        dsum[i] = fmaf(round_to<T>(e) * il[i], dp[i][j], dsum[i]);
        pss[(ty + 16 * i) * SLd + tx + 16 * j] = e * il[i];
        pds[(ty + 16 * i) * SLd + tx + 16 * j] = e * il[i] * dp[i][j];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < S; ++key) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = ks[key * Ld + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pd = pds[(ty + 16 * i) * SLd + key];
        const float pk = pss[(ty + 16 * i) * SLd + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] = fmaf(pd, b[c], acc[i][c]);
          accb[i][c] = fmaf(pk, b[c], accb[i][c]);
        }
      }
    }
  }
  float* m_out = stats;
  float* l_out = stats + (size_t)BH * Sq;
  float* d_out = stats + (size_t)2 * BH * Sq;
  T* dqb = dq + (size_t)bh * Sq * Dk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float di = warp_sum16(dsum[i]);  // the row's 16 threads
    const int r = row0 + ty + 16 * i;
    if (r >= Sq) continue;
    if (tx == 0) {
      m_out[(size_t)bh * Sq + r] = m[i];
      l_out[(size_t)bh * Sq + r] = l[i];
      d_out[(size_t)bh * Sq + r] = di;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqb[(size_t)r * Dk + tx + 16 * c] =
          from_float<T>((acc[i][c] - di * accb[i][c]) * scale);
  }
}

// dK and dV. Grid (ceil(Skv / 64), BHkv); the heaviest key tiles (the
// first, under a causal mask) are scheduled first. A range policy walks
// the G heads' query tiles [t0, t1) in turn; a list policy (kLists) its
// key tile's entries, one pass of the outer loop. The loops over Dk- and
// Dv-wide columns share one loop over the wider, guarded by each width:
// at Dk = Dv the guards fold away and the kernel is the one it was before
// it took two widths.
template <typename T, int Dk, int Dv, class Policy>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int BH, int Sq, int Skv, int G, float scale,
            Policy pol) {
  using Ti = Tiles<Dk, Dv>;
  constexpr int S = Ti::kStep, Ld = Ti::kLd, VLd = Ti::kVLd, SLd = Ti::kSLd;
  constexpr int NJ = Ti::kJ, NC = Ti::kCols, NV = Ti::kVCols;
  constexpr int NM = NC > NV ? NC : NV;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kRows * Ld;
  float* qs = vs + kRows * VLd;
  float* dos = qs + S * Ld;
  float* ps = dos + S * VLd;
  float* dss = ps + kRows * SLd;
  float* ms = dss + kRows * SLd;
  float* ls = ms + S;
  float* ds_row = ls + S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int c0 = blockIdx.x * kRows;
  load_rows<T, Dk, Ld>(ks, k + (size_t)bkv * Skv * Dk, c0, kRows, Skv);
  load_rows<T, Dv, VLd>(vs, v + (size_t)bkv * Skv * Dv, c0, kRows, Skv);

  float gk[4][NC], gv[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      if (c < NC) gk[i][c] = 0.f;
      if (c < NV) gv[i][c] = 0.f;
    }
  int t0, t1;
  pol.query_tiles(bkv, c0, min(c0 + kRows, Skv) - 1, Sq, S, t0, t1);
  const float* m_in = stats;
  const float* l_in = stats + (size_t)BH * Sq;
  const float* d_in = stats + (size_t)2 * BH * Sq;

  for (int g = 0; g < (Policy::kLists ? 1 : G); ++g) {
    const int bh0 = bkv * G + g;
    for (int t = t0; t < t1; ++t) {
      int bh = bh0, rq0 = t * S;
      if constexpr (Policy::kLists) {
        bh = pol.step_head(bkv, c0, t, G);
        rq0 = pol.step_tile(bkv, c0, t) * S;
      }
      __syncthreads();  // the previous step's reads are done
      load_rows<T, Dk, Ld>(qs, q + (size_t)bh * Sq * Dk, rq0, S, Sq);
      load_rows<T, Dv, VLd>(dos, dout + (size_t)bh * Sq * Dv, rq0, S, Sq);
      for (int e = threadIdx.x; e < S; e += kThreads) {
        const int r = rq0 + e;
        const bool in = r < Sq;
        ms[e] = in ? m_in[(size_t)bh * Sq + r] : 0.f;
        ls[e] = in ? l_in[(size_t)bh * Sq + r] : 1.f;
        ds_row[e] = in ? d_in[(size_t)bh * Sq + r] : 0.f;
      }
      __syncthreads();
      // s and dp transposed: key rows ty + 16 i, query columns tx + 16 j
      float s[4][NJ], dp[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < Ti::kDMax; ++d) {
        float a[4], av[4], b[NJ], bo[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = d < Dk ? ks[(ty + 16 * i) * Ld + d] : 0.f;
          av[i] = d < Dv ? vs[(ty + 16 * i) * VLd + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          b[j] = d < Dk ? qs[(tx + 16 * j) * Ld + d] : 0.f;
          bo[j] = d < Dv ? dos[(tx + 16 * j) * VLd + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(av[i], bo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = c0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int jj = tx + 16 * j;
          const int r = rq0 + jj;
          const bool live = key < Skv && r < Sq && pol.visible(r, key);
          const float e = live ? expf(s[i][j] * scale - ms[jj]) : 0.f;
          const float il = 1.f / fmaxf(ls[jj], 1e-20f);
          ps[(ty + 16 * i) * SLd + jj] = round_to<T>(e) * il;
          dss[(ty + 16 * i) * SLd + jj] = e * il * (dp[i][j] - ds_row[jj]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < S; ++r) {
        float bq[NC], bo[NV];
#pragma unroll
        for (int c = 0; c < NM; ++c) {
          if (c < NC) bq[c] = qs[r * Ld + tx + 16 * c];
          if (c < NV) bo[c] = dos[r * VLd + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[(ty + 16 * i) * SLd + r];
          const float ds = dss[(ty + 16 * i) * SLd + r];
#pragma unroll
          for (int c = 0; c < NM; ++c) {
            if (c < NV) gv[i][c] = fmaf(p, bo[c], gv[i][c]);
            if (c < NC) gk[i][c] = fmaf(ds, bq[c], gk[i][c]);
          }
        }
      }
    }
  }
  T* dkb = dk + (size_t)bkv * Skv * Dk;
  T* dvb = dv + (size_t)bkv * Skv * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty + 16 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      if (c < NC)
        dkb[(size_t)key * Dk + tx + 16 * c] = from_float<T>(gk[i][c] * scale);
      if (c < NV)
        dvb[(size_t)key * Dv + tx + 16 * c] = from_float<T>(gv[i][c]);
    }
  }
}

// Both kernels on `stream`, dq's first (dkdv reads its stats). q, dout
// (BH, Sq, Dk / Dv), k, v (BHkv, Skv, Dk / Dv), dq, dk, dv likewise;
// stats (3, BH, Sq) float32 scratch.
template <typename T, int Dk, int Dv, class Policy>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk,
                   void* dv, float* stats, int BH, int BHkv, int Sq, int Skv,
                   float scale, Policy pol, cudaStream_t stream) {
  using Ti = Tiles<Dk, Dv>;
  auto kq = dq_kernel<T, Dk, Dv, Policy>;
  auto kkv = dkdv_kernel<T, Dk, Dv, Policy>;
  cudaError_t e = allow_smem(kq, Ti::kDqBytes);
  if (e != cudaSuccess) return e;
  e = allow_smem(kkv, Ti::kDkdvBytes);
  if (e != cudaSuccess) return e;
  const int G = BH / BHkv;
  kq<<<dim3((Sq + kRows - 1) / kRows, BH), kThreads, Ti::kDqBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), stats, BH, Sq, Skv,
      G, scale, pol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((Skv + kRows - 1) / kRows, BHkv), kThreads, Ti::kDkdvBytes,
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  stats, static_cast<T*>(dk), static_cast<T*>(dv), BH, Sq,
                  Skv, G, scale, pol);
  return cudaSuccess;
}

}  // namespace bwd
}  // namespace flux
