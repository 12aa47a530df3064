// Fused Lee–Seung MU half-steps under the Frobenius objective, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py).
//
//   W half-step:  W' = W ⊙ (s · V Hᵀ) / (W G + eps),  G = H Hᵀ  (r, r)
//   H half-step:  H' = H ⊙ (s · Wᵀ V) / (G H + eps),  G = Wᵀ W  (r, r)
//
// V is (n, m), W (n, r), H (r, m), all row-major and contiguous; W, H, G
// and the output are float32. The kernels are templates over V's element
// type: `float` with s = 1 (replaces nmftpu/kernels/dense_mu.py:277
// w_update_fused and :188 h_update_fused), and `int8_t` with the
// per-matrix scale s read from device memory (replaces
// nmftpu/kernels/quantized.py:148 w_update_fused_q and :70
// h_update_fused_q). The int8 values upcast to float exactly, and s
// multiplies each numerator once in the epilogue, as quantized.py does.
//
// Precision contract: operands are NOT rounded to bf16 as the TPU kernels
// do. Every product and sum runs in float32 on the CUDA cores (fmaf, in
// depth order 0..K-1), and the epilogue divides with IEEE rounding. The
// result matches the plain torch twin (kernels/dense_mu.py, quantized.py)
// up to float32 summation order: relative error ~ sqrt(K) * 2^-24 on
// nonnegative data, checked against rtol 1e-4 on the card.
//
// What bounds it on the H100: each V element feeds 2r flops per half-step,
// 128 flop/byte for float32 V at r = 256 and 512 for int8 V. Against the
// 67 TFLOP/s of float32 on the CUDA cores and 3.35 TB/s of HBM (about 20
// flop/byte) both are compute-bound, so this first version spends nothing
// on memory tricks: a 64 x 64 output tile per block, 4 x 4 outputs per
// thread, depth staged through shared memory in slices of 32, the
// numerator and then the (full-r) denominator accumulated in registers,
// and the multiply/divide epilogue fused before the only store. The
// numerator is never written to device memory. Against bf16 tensor cores
// (about 295 flop/byte) the same loop would be memory-bound; wgmma, TMA
// and a persistent schedule are later work.
//
// The output is a separate buffer: other blocks read whole rows of W
// (columns of H) for their denominators, so it must not alias W or H.
// Ragged edges are masked in the loads (zero fill) and in the store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                  // output rows per block
constexpr int BN = 64;                  // output columns per block
constexpr int BK = 32;                  // depth per shared-memory slice
constexpr int THREADS = 256;            // 16 x 16 threads
constexpr int TM = BM / 16;             // outputs per thread along rows
constexpr int TN = BN / 16;             // outputs per thread along columns
constexpr int LDS = BM + 1;             // odd stride: conflict-free stores
static_assert(BM == BN, "one shared tile shape serves both operands");

// Stage a (64 x BK) slice of an operand into s[k][i]. Element (i, k) of
// the operand lives at p[i * ld + k] when KCONTIG (depth contiguous), else
// at p[k * ld + i]. Consecutive threads walk the contiguous index, so the
// global reads coalesce either way. Out-of-range elements read as zero.
template <bool KCONTIG, typename T>
__device__ __forceinline__ void load_slice(float (*s)[LDS],
                                           const T* __restrict__ p,
                                           long long ld, int i0, int k0,
                                           int rows, int depth) {
#pragma unroll
  for (int t = 0; t < (BM * BK) / THREADS; ++t) {
    const int e = threadIdx.x + t * THREADS;
    const int i = KCONTIG ? e / BK : e % BM;
    const int k = KCONTIG ? e % BK : e / BM;
    const int gi = i0 + i;
    const int gk = k0 + k;
    float v = 0.f;
    if (gi < rows && gk < depth) {
      const long long off = KCONTIG ? (long long)gi * ld + gk
                                    : (long long)gk * ld + gi;
      v = static_cast<float>(p[off]);
    }
    s[k][i] = v;
  }
}

// acc[u][v] += sum_k A(i0 + ty + 16u, k) * B(j0 + tx + 16v, k) over
// k in [0, depth), A with `rows_a` rows and B with `rows_b` rows.
template <bool A_KCONTIG, bool B_KCONTIG, typename TA, typename TB>
__device__ __forceinline__ void block_gemm(
    float (&acc)[TM][TN], float (*As)[LDS], float (*Bs)[LDS],
    const TA* __restrict__ A, long long lda, int rows_a,
    const TB* __restrict__ B, long long ldb, int rows_b,
    int depth, int i0, int j0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < depth; k0 += BK) {
    load_slice<A_KCONTIG>(As, A, lda, i0, k0, rows_a, depth);
    load_slice<B_KCONTIG>(Bs, B, ldb, j0, k0, rows_b, depth);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) a[u] = As[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < TN; ++v) b[v] = Bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
}

// out = x * (num * s) / (den + eps) for this thread's outputs; x and out
// are (rows, cols) row-major.
__device__ __forceinline__ void epilogue(
    const float (&num)[TM][TN], const float (&den)[TM][TN],
    const float* __restrict__ x, float* __restrict__ out, int rows, int cols,
    int i0, int j0, float s, float eps) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= rows) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j >= cols) continue;
      const long long off = (long long)i * cols + j;
      out[off] = x[off] * (num[u][v] * s) / (den[u][v] + eps);
    }
  }
}

// W half-step. Block (bx, by) owns rows [64 bx, +64) of W' and factor
// columns [64 by, +64). Numerator: A = V (depth m contiguous), B = H
// (depth m contiguous). Denominator: A = W (depth r contiguous),
// B(j, k) = G[k, j].
template <typename TV>
__global__ void __launch_bounds__(THREADS)
w_update_kernel(const TV* __restrict__ V, const float* __restrict__ scale,
                const float* __restrict__ W, const float* __restrict__ H,
                const float* __restrict__ G, float* __restrict__ out,
                int n, int m, int r, float eps) {
  __shared__ float As[BK][LDS];
  __shared__ float Bs[BK][LDS];
  const int i0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  float num[TM][TN] = {};
  block_gemm<true, true>(num, As, Bs, V, m, n, H, m, r, m, i0, j0);
  float den[TM][TN] = {};
  block_gemm<true, false>(den, As, Bs, W, r, n, G, r, r, r, i0, j0);
  const float s = scale ? *scale : 1.f;
  epilogue(num, den, W, out, n, r, i0, j0, s, eps);
}

// H half-step. Block (bx, by) owns item columns [64 bx, +64) of H' and
// factor rows [64 by, +64). Numerator: A(i, k) = W[k, i], B(j, k) =
// V[k, j], depth n. Denominator: A = G (depth r contiguous),
// B(j, k) = H[k, j].
template <typename TV>
__global__ void __launch_bounds__(THREADS)
h_update_kernel(const TV* __restrict__ V, const float* __restrict__ scale,
                const float* __restrict__ W, const float* __restrict__ H,
                const float* __restrict__ G, float* __restrict__ out,
                int n, int m, int r, float eps) {
  __shared__ float As[BK][LDS];
  __shared__ float Bs[BK][LDS];
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  float num[TM][TN] = {};
  block_gemm<false, false>(num, As, Bs, W, r, r, V, m, m, n, i0, j0);
  float den[TM][TN] = {};
  block_gemm<true, false>(den, As, Bs, G, r, r, H, m, m, r, i0, j0);
  const float s = scale ? *scale : 1.f;
  epilogue(num, den, H, out, r, m, i0, j0, s, eps);
}

template <typename TV>
int launch_w(const TV* V, const float* scale, const float* W, const float* H,
             const float* G, float* out, int n, int m, int r, float eps,
             cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, (r + BN - 1) / BN);
  w_update_kernel<TV><<<grid, THREADS, 0, stream>>>(V, scale, W, H, G, out,
                                                    n, m, r, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV>
int launch_h(const TV* V, const float* scale, const float* W, const float* H,
             const float* G, float* out, int n, int m, int r, float eps,
             cudaStream_t stream) {
  const dim3 grid((m + BN - 1) / BN, (r + BM - 1) / BM);
  h_update_kernel<TV><<<grid, THREADS, 0, stream>>>(V, scale, W, H, G, out,
                                                    n, m, r, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every entry launches on `stream` and returns
// cudaGetLastError() (0 = launched). `scale` is a device pointer to one
// float (the int8 entries) or null (the float32 entries, s = 1).
extern "C" {

int nmftpu_w_update_f32(const float* V, const float* scale, const float* W,
                        const float* H, const float* G, float* out, int n,
                        int m, int r, float eps, cudaStream_t stream) {
  return launch_w<float>(V, scale, W, H, G, out, n, m, r, eps, stream);
}

int nmftpu_h_update_f32(const float* V, const float* scale, const float* W,
                        const float* H, const float* G, float* out, int n,
                        int m, int r, float eps, cudaStream_t stream) {
  return launch_h<float>(V, scale, W, H, G, out, n, m, r, eps, stream);
}

int nmftpu_w_update_i8(const int8_t* V, const float* scale, const float* W,
                       const float* H, const float* G, float* out, int n,
                       int m, int r, float eps, cudaStream_t stream) {
  return launch_w<int8_t>(V, scale, W, H, G, out, n, m, r, eps, stream);
}

int nmftpu_h_update_i8(const int8_t* V, const float* scale, const float* W,
                       const float* H, const float* G, float* out, int n,
                       int m, int r, float eps, cudaStream_t stream) {
  return launch_h<int8_t>(V, scale, W, H, G, out, n, m, r, eps, stream);
}

const char* nmftpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
