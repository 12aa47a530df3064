// Fused scoring + top-2-per-slot reservoir scan for top-k MIPS serving, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py).
//
// Replaces the TPU kernel nmftpu/kernels/mips_reservoir.py:135
// reservoir_topk_mips (its scan _reservoir_scan :90, pallas_call :107).
//
// For queries Wq (b, r) and the item table H (r, ldh), items [0, m): slot
// s of a reservoir of R slots sees items j * R + s, j = 0, 1, ...; for each
// (query, slot) the kernel keeps the best two (score, id) pairs under
// nmftpu's merge rule (mips_reservoir.py:79-83), strict '>' throughout, so
// a tie keeps the earlier, lower id. It writes the best to out[:, s] and
// the second to out[:, R + s] (scores float32, ids int32), as the TPU
// kernel's concatenate does. Slots that see no item keep (-inf, 0).
//
// Precision contract (mips_tile.cuh): bf16-rounded queries, the exact
// table value (float32, bf16 or int8), float32 fmaf in k order.
//
// Work split: block (x, y) owns queries [64 y, +64) and slots
// [64 x, +64), so no two blocks touch the same output and nothing is
// merged across blocks. The block stages its queries once, then walks
// the tiles j in increasing order; each (64 x 64) score tile is summed in
// registers and merged into the carry (four registers per (query, slot))
// at once. No score reaches device memory. Columns beyond R or m score
// -inf and are never read.
//
// What bounds it on the H100: a scan costs 2·b·r·m flops, 2.75 TFLOP at
// b = 512, r = 256, m = 10,485,760. On the CUDA cores at about 67 TFLOP/s
// float32 that is at least 41 ms. The table is read once per 64-query
// block, b/64 × r·m bytes: 21 GB for int8 at b = 512, about 6.4 ms at
// 3.35 TB/s. So this kernel is compute-bound, and per k step each thread
// issues 8 shared-memory loads for 16 FMAs. bf16 tensor cores (wgmma),
// TMA and a persistent schedule are where its next version goes.

#include "mips_tile.cuh"

namespace {

using namespace nmftpu_mips;

template <typename T>
__global__ void __launch_bounds__(THREADS)
reservoir_kernel(const float* __restrict__ Wq, const T* __restrict__ H,
                 float* __restrict__ out_s, int* __restrict__ out_i, int b,
                 int r, int m, long long ldh, int R) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Hs = smem + static_cast<size_t>(padded_rank(r)) * LDQ;
  const int s0 = blockIdx.x * TS;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  stage_queries(Qs, Wq, b, r, q0);
  __syncthreads();

  float s1[TQ][TN], s2[TQ][TN];
  int i1[TQ][TN], i2[TQ][TN];
#pragma unroll
  for (int u = 0; u < TQ; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      s1[u][v] = s2[u][v] = -INFINITY;
      i1[u][v] = i2[u][v] = 0;
    }

  const int slot_cols = R - s0 < TS ? R - s0 : TS;
  for (long long c0 = s0; c0 < m; c0 += R) {   // tile j: c0 = j * R + s0
    const int ncols = m - c0 < slot_cols ? static_cast<int>(m - c0)
                                         : slot_cols;
    float acc[TQ][TN];
    score_tile(acc, Qs, Hs, H, ldh, r, c0, ncols);
#pragma unroll
    for (int u = 0; u < TQ; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int col = tx + 16 * v;
        const float s = col < ncols ? acc[u][v] : -INFINITY;
        const int gid = static_cast<int>(c0) + col;
        const bool beats1 = s > s1[u][v];
        i2[u][v] = beats1 ? i1[u][v] : (s > s2[u][v] ? gid : i2[u][v]);
        s2[u][v] = fmaxf(fminf(s, s1[u][v]), s2[u][v]);
        i1[u][v] = beats1 ? gid : i1[u][v];
        s1[u][v] = fmaxf(s, s1[u][v]);
      }
  }

  const long long ld_out = 2LL * R;
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int q = q0 + ty + 16 * u;
    if (q >= b) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int col = tx + 16 * v;
      if (col >= slot_cols) continue;
      const long long off = q * ld_out + s0 + col;
      out_s[off] = s1[u][v];
      out_i[off] = i1[u][v];
      out_s[off + R] = s2[u][v];
      out_i[off + R] = i2[u][v];
    }
  }
}

template <typename T>
int launch(const float* Wq, const T* H, float* out_s, int* out_i, int b,
           int r, int m, long long ldh, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      reservoir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TS - 1) / TS, (b + BQ - 1) / BQ);
  reservoir_kernel<T><<<grid, THREADS, smem, stream>>>(Wq, H, out_s, out_i,
                                                       b, r, m, ldh, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: Wq (b, r) float32; H (r, ldh) of the entry's type, items
// [0, m); out_s (b, 2R) float32 and out_i (b, 2R) int32. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" {

int nmftpu_reservoir_scan_f32(const float* Wq, const float* H, float* out_s,
                              int* out_i, int b, int r, int m, long long ldh,
                              int R, cudaStream_t stream) {
  return launch<float>(Wq, H, out_s, out_i, b, r, m, ldh, R, stream);
}

int nmftpu_reservoir_scan_bf16(const float* Wq, const __nv_bfloat16* H,
                               float* out_s, int* out_i, int b, int r, int m,
                               long long ldh, int R, cudaStream_t stream) {
  return launch<__nv_bfloat16>(Wq, H, out_s, out_i, b, r, m, ldh, R,
                               stream);
}

int nmftpu_reservoir_scan_i8(const float* Wq, const int8_t* H, float* out_s,
                             int* out_i, int b, int r, int m, long long ldh,
                             int R, cudaStream_t stream) {
  return launch<int8_t>(Wq, H, out_s, out_i, b, r, m, ldh, R, stream);
}

}  // extern "C"
