// Fused scoring + count-above-threshold, the certificate's count pass of
// top-k serving, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (nmftpu_torch/kernels/_build.py).
//
// Replaces the TPU kernel nmftpu/kernels/count_above.py:95
// count_above_fused (its scan _count_scan :71, pallas_call :76).
//
// For queries Wq (b, r), the item table H (r, ldh) with items [0, m) and
// thresholds theta (b,): counts[q] += the number of items whose score is
// strictly above theta[q]. The wrapper zeroes `counts` first. A row whose
// theta is -inf counts every item; rows q >= b are masked here, so the
// wrapper pads nothing.
//
// Precision contract (mips_tile.cuh): bf16-rounded queries, the exact
// table value (bf16 or int8), float32 fmaf in k order. A scalar int8 scale
// is folded into theta by the wrapper, a (r,) one into the queries.
//
// Work split: block (x, y) owns queries [64 y, +64) and the items of
// TILES consecutive 64-column tiles. It stages its queries once, scores
// each (64 x 64) tile in registers, and compares each score with its
// row's theta there; no score is written. Each thread keeps one count
// per query it owns; the 16 threads of a row reduce theirs with warp
// shuffles, and one atomicAdd per (query, block) adds the block's count.
// Integer sums are order-free, so the counts do not depend on the order
// in which blocks run.
//
// What bounds it on the H100: the same 2·b·r·m flops as the reservoir
// scan (2.75 TFLOP at b = 512, r = 256, m = 10,485,760; at least 41 ms
// on the float32 CUDA cores), against b/64 reads of the table (21 GB
// for int8 at b = 512). Compute-bound, like mips_reservoir.cu; tensor
// cores are its next step.

#include "mips_tile.cuh"

namespace {

using namespace nmftpu_mips;

constexpr int TILES = 32;    // 64-column tiles per block: 2048 items

template <typename T>
__global__ void __launch_bounds__(THREADS)
count_kernel(const float* __restrict__ Wq, const T* __restrict__ H,
             const float* __restrict__ theta, int* __restrict__ counts,
             int b, int r, int m, long long ldh) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Hs = smem + static_cast<size_t>(padded_rank(r)) * LDQ;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  stage_queries(Qs, Wq, b, r, q0);
  float th[TQ];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int q = q0 + ty + 16 * u;
    th[u] = q < b ? theta[q] : INFINITY;
  }
  __syncthreads();

  int cnt[TQ] = {};
  const long long first = static_cast<long long>(blockIdx.x) * TILES * TS;
  for (int t = 0; t < TILES; ++t) {
    const long long c0 = first + static_cast<long long>(t) * TS;
    if (c0 >= m) break;                          // uniform across the block
    const int ncols = m - c0 < TS ? static_cast<int>(m - c0) : TS;
    float acc[TQ][TN];
    score_tile(acc, Qs, Hs, H, ldh, r, c0, ncols);
#pragma unroll
    for (int u = 0; u < TQ; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        cnt[u] += (tx + 16 * v < ncols && acc[u][v] > th[u]) ? 1 : 0;
  }

  // reduce over the 16 threads (tx) that share a row: lanes 0-15 and 16-31
  // of each warp are two rows, and xor offsets below 16 stay within one
#pragma unroll
  for (int u = 0; u < TQ; ++u)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      cnt[u] += __shfl_xor_sync(0xffffffffu, cnt[u], off);
  if (tx == 0) {
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int q = q0 + ty + 16 * u;
      if (q < b && cnt[u] != 0) atomicAdd(&counts[q], cnt[u]);
    }
  }
}

template <typename T>
int launch(const float* Wq, const T* H, const float* theta, int* counts,
           int b, int r, int m, long long ldh, cudaStream_t stream) {
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (static_cast<long long>(m) + TS - 1) / TS;
  const dim3 grid(static_cast<unsigned>((tiles + TILES - 1) / TILES),
                  (b + BQ - 1) / BQ);
  count_kernel<T><<<grid, THREADS, smem, stream>>>(Wq, H, theta, counts, b,
                                                   r, m, ldh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: Wq (b, r) float32; H (r, ldh) of the entry's type, items
// [0, m); theta (b,) float32; counts (b,) int32, zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" {

int nmftpu_count_above_bf16(const float* Wq, const __nv_bfloat16* H,
                            const float* theta, int* counts, int b, int r,
                            int m, long long ldh, cudaStream_t stream) {
  return launch<__nv_bfloat16>(Wq, H, theta, counts, b, r, m, ldh, stream);
}

int nmftpu_count_above_i8(const float* Wq, const int8_t* H,
                          const float* theta, int* counts, int b, int r,
                          int m, long long ldh, cudaStream_t stream) {
  return launch<int8_t>(Wq, H, theta, counts, b, r, m, ldh, stream);
}

}  // extern "C"
