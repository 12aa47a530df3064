// The scoring tile shared by the serving kernels (mips_reservoir.cu,
// count_above.cu): a block of 64 queries held in shared memory for the
// whole scan, times one 64-column slice of the item table, summed in
// float32 registers.
//
// Precision contract, the same in both kernels and in their plain torch
// twins (nmftpu_torch/kernels/): each query value is rounded to bf16
// (round to nearest even, after any per-dimension int8 scale was folded
// in by the wrapper); each table value is taken exactly (float32, bf16, or
// int8 converted to float); each score is the chain
// acc = fmaf(q[k], h[k], acc) for k = 0, 1, ..., r-1 from acc = 0. For bf16
// and int8 tables every product is exact in float32, so that chain equals
// any k-ordered float32 sum of the products; retrieval/mips.py's
// _gather_scores forms exactly that sum for single (query, item) pairs.
//
// Layout: 256 threads as 16 x 16; thread (tx, ty) owns queries
// ty + 16u (u < 4) and columns tx + 16v (v < 4) of the 64 x 64 tile.
// Dynamic shared memory holds the query block as Qs[k][i] with an odd
// stride (LDQ = 65), k < rp = r rounded up to BK with zero rows beyond r,
// followed by one (BK x 64) float32 slice of the table.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nmftpu_mips {

constexpr int BQ = 64;            // queries per block
constexpr int TS = 64;            // table columns per tile
constexpr int BK = 32;            // depth per table slice
constexpr int THREADS = 256;      // 16 x 16
constexpr int TQ = BQ / 16;       // queries per thread
constexpr int TN = TS / 16;       // columns per thread
constexpr int LDQ = BQ + 1;       // odd stride: conflict-free staging

__host__ __device__ inline int padded_rank(int r) {
  return (r + BK - 1) / BK * BK;
}

// Bytes of dynamic shared memory a block needs at rank r.
__host__ inline size_t smem_bytes(int r) {
  return sizeof(float) * (static_cast<size_t>(padded_rank(r)) * LDQ +
                          BK * TS);
}

__device__ __forceinline__ float table_value(float v) { return v; }
__device__ __forceinline__ float table_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float table_value(int8_t v) {
  return static_cast<float>(v);
}

// Qs[k * LDQ + i] = bf16(Wq[q0 + i, k]) for rows q0 + i < b and k < r,
// else 0. Wq is (b, r) row-major float32.
__device__ __forceinline__ void stage_queries(float* Qs,
                                              const float* __restrict__ Wq,
                                              int b, int r, int q0) {
  const int rp = padded_rank(r);
  for (int e = threadIdx.x; e < rp * BQ; e += THREADS) {
    const int i = e / rp;
    const int k = e % rp;             // consecutive threads: consecutive k
    float v = 0.f;
    if (q0 + i < b && k < r) {
      v = __bfloat162float(
          __float2bfloat16_rn(Wq[static_cast<long long>(q0 + i) * r + k]));
    }
    Qs[k * LDQ + i] = v;
  }
}

// acc[u][v] = sum over k < r of Qs[k][ty + 16u] * H[k, c0 + tx + 16v], as
// one fmaf chain in k order. Columns at or beyond `ncols` read as zero.
// H is (r, ldh) row-major; c0 + ncols <= ldh. Every thread of the block
// must call it (it synchronises).
template <typename T>
__device__ __forceinline__ void score_tile(float (&acc)[TQ][TN],
                                           const float* Qs, float* Hs,
                                           const T* __restrict__ H,
                                           long long ldh, int r,
                                           long long c0, int ncols) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < TQ; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
  const int rp = padded_rank(r);
  for (int k0 = 0; k0 < rp; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (BK * TS) / THREADS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      const int k = e / TS;
      const int c = e % TS;           // consecutive threads: consecutive c
      float v = 0.f;
      if (k0 + k < r && c < ncols) {
        v = table_value(H[static_cast<long long>(k0 + k) * ldh + c0 + c]);
      }
      Hs[k * TS + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TQ], h[TN];
#pragma unroll
      for (int u = 0; u < TQ; ++u) a[u] = Qs[(k0 + k) * LDQ + ty + 16 * u];
#pragma unroll
      for (int v = 0; v < TN; ++v) h[v] = Hs[k * TS + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < TQ; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(a[u], h[v], acc[u][v]);
    }
    __syncthreads();
  }
}

}  // namespace nmftpu_mips
