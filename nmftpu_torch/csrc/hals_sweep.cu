// One blocked Gauss–Seidel HALS half-sweep for Hopper (sm_90a), float32,
// with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py). Replaces
// nmftpu/kernels/hals_sweep.py:121 hals_sweep (_sweep_kernel_t).
//
//   for t in 0 .. r-1:
//     W[:, t] <- max(W[:, t] - (W G[:, t] - XHt[:, t]) / G[t, t], 0)
//
// sequentially in t, a column whose hessian G[t, t] is 0 left as it is.
// XHt and W are (n, r), G is (r, r), all row-major and contiguous; the
// result goes to a separate (n, r) buffer.
//
// Rows of W are independent and columns sequential, so one warp owns one
// row of W, held in shared memory for the whole sweep, and a block of
// WARPS rows shares G. Per block of b <= 16 columns starting at s (the
// last block shorter when b does not divide r, exactly as
// linalg.dense._hals_half_sweep_blocked):
//   * G[:, s:s+b] is staged in shared memory in slices of KC rows (all r
//     rows of G do not fit at r = 256: 256 KiB), and lane (t, half) sums
//     w[k] G[k, s+t] over its half of k; a shuffle joins the halves, so
//     lanes t and t + 16 hold base[t] = W[row] · G[:, s+t] - XHt[row, s+t];
//   * the b-step chain runs in registers: at step j every lane takes
//     base[j] by shuffle, computes the same new value of column s+j and
//     shifts its own base[t] by delta * G[s+j, s+t] (the rank-1
//     correction), reading the (b, b) diagonal block of G from shared
//     memory;
//   * the b new values are written to the row in shared memory after the
//     chain (each column is updated once per sweep, so the chain reads
//     the old values).
// No atomics; the output is deterministic. Sums are float32 fmaf, in
// another order than the plain blocked sweep: agreement is to roundoff,
// which the clamp and the division by the hessian can amplify (the tests
// and chip_smoke.py hold it to 3e-5 * max|W|, the bound nmftpu's own
// tests put on its Pallas sweep).
//
// What bounds it on the H100: about 2 n r^2 + 2 n r b operations on
// 3 n r float32 values read or written (at 4096 x 256, 0.57 GFLOP and
// 12.6 MB), i.e. about 45 flop/byte over the 20 of the float32 CUDA
// cores (67 TFLOP/s) against HBM (3.35 TB/s): operations bound. This
// first version feeds each fmaf from two shared-memory reads, so
// shared-memory bandwidth, not the FMA rate, is its ceiling; keeping the
// row in registers and tensor-core bases are later work.

#include <cuda_runtime.h>

namespace {

constexpr int MAXB = 16;        // widest column block
constexpr int KC = 256;         // rows of G's column block per staging pass
constexpr unsigned FULL = 0xffffffffu;

__global__ void hals_sweep_kernel(const float* __restrict__ XHt,
                                  const float* __restrict__ G,
                                  const float* __restrict__ W,
                                  float* __restrict__ out, int n, int r,
                                  int block) {
  extern __shared__ float smem[];
  float* Gs = smem;                        // [KC][MAXB]: G[k0 + k, s + t]
  float* Gbb = Gs + KC * MAXB;             // [MAXB][MAXB]: G[s + j, s + t]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* w = Gbb + MAXB * MAXB + warp * r; // this warp's row of W
  const long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = row < n;
  if (live)
    for (int k = lane; k < r; k += 32) w[k] = W[row * r + k];
  const int t = lane % MAXB;               // the column of the block
  const int half = lane / MAXB;            // which half of k this lane sums

  for (int s = 0; s < r; s += block) {
    const int b = min(block, r - s);
    float acc = 0.f;
    for (int k0 = 0; k0 < r; k0 += KC) {
      const int kc = min(KC, r - k0);
      __syncthreads();                     // earlier readers are done
      for (int e = threadIdx.x; e < kc * MAXB; e += blockDim.x) {
        const int k = e / MAXB, c = e % MAXB;
        Gs[e] = c < b ? G[static_cast<long long>(k0 + k) * r + s + c] : 0.f;
      }
      if (k0 == 0)
        for (int e = threadIdx.x; e < MAXB * MAXB; e += blockDim.x) {
          const int j = e / MAXB, c = e % MAXB;
          Gbb[e] = (j < b && c < b)
                       ? G[static_cast<long long>(s + j) * r + s + c] : 0.f;
        }
      __syncthreads();
      if (live)
        for (int k = half; k < kc; k += 2)
          acc = fmaf(w[k0 + k], Gs[k * MAXB + t], acc);
    }
    acc += __shfl_xor_sync(FULL, acc, MAXB);
    float base = acc - ((live && t < b) ? XHt[row * r + s + t] : 0.f);
    float mine = 0.f;                      // the new value of column s + t
    for (int j = 0; j < b; ++j) {
      const float grad = __shfl_sync(FULL, base, j);
      const float hess = Gbb[j * MAXB + j];
      const float old = w[s + j];
      const float nv = hess != 0.f ? fmaxf(old - grad / hess, 0.f) : old;
      if (t == j) mine = nv;
      base = fmaf(nv - old, Gbb[j * MAXB + t], base);
    }
    __syncwarp();                          // every lane has read the row
    if (live && half == 0 && t < b) w[s + t] = mine;
  }
  __syncwarp();
  if (live)
    for (int k = lane; k < r; k += 32) out[row * r + k] = w[k];
}

}  // namespace

extern "C" {

// out (n, r) = one HALS half-sweep of W (n, r) against XHt (n, r) and the
// Gram G (r, r), in column blocks of `block` (1..16). Launches on `stream`
// and returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for a block width or rank it cannot take.
int nmftpu_hals_sweep_f32(const float* XHt, const float* G, const float* W,
                          float* out, int n, int r, int block,
                          cudaStream_t stream) {
  if (block < 1 || block > MAXB || r < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the most rows per block (8 warps down to 1) whose rows and G's
  // staged slices fit the 227 KiB a block may have
  const size_t fixed = sizeof(float) * (KC * MAXB + MAXB * MAXB);
  int warps = 8;
  while (warps > 1 && fixed + sizeof(float) * warps * r > 232448) warps /= 2;
  const size_t bytes = fixed + sizeof(float) * warps * static_cast<size_t>(r);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      hals_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + warps - 1) / warps);
  hals_sweep_kernel<<<blocks, 32 * warps, bytes, stream>>>(XHt, G, W, out, n,
                                                           r, block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
