// ELL segment SpMM: per padded segment s of one ELL bucket,
//
//     out[s, :] = Σ_{k < w} vals[s, k] · table[cols[s, k], :]      (nseg, r)
//
// for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py).
//
// Replaces the TPU kernel nmftpu/kernels/sparse_ell_kernel.py:98
// bucket_rowsums_pallas (kernel _make_seg_rowsum_kernel :58, pallas_call
// :140). The contract is the TPU kernel's: segment sums only. The scatter
// of segments into rows stays outside, as an index_add_ on out_row (the
// TPU version leaves it to an XLA sorted scatter). Pad lanes are
// (col 0, val 0) and pad segments are all zero, so they add exact zeros
// and need no special case. The TPU's VMEM table budget, one-step grid and
// scan over segment groups are not carried over: here the table stays in
// global memory and L2, and one launch covers the whole bucket.
//
// Precision contract: a template over float and double that multiplies
// and accumulates in the element type (fma in k order, 0..w-1). The TPU
// kernel sums in float32 even for a float64 table; this one does not.
// Against the plain torch twin (kernels/sparse_ell_kernel.py
// bucket_rowsums_plain, another summation order) the relative error is
// about sqrt(w) · 2^-24 in float32 on nonnegative data (w <= 512).
//
// Work split: one warp owns one segment at a time, and a grid-stride loop
// walks the segments. The warp reads the segment's cols/vals 32 at a time
// (coalesced) and broadcasts each (col, val) pair with __shfl_sync. Lane l
// owns VEC contiguous columns in each of NP 32·VEC-column groups of the
// gathered table row, so one table row is read as one coalesced 256 B
// (r = 64, float2) or 512 B (r = 128, float4) access; columns beyond r
// are masked, and rows wider than 32·VEC·NP run in several passes. The k
// loop is unrolled by four, so four independent row gathers are in flight
// per warp (the gather is latency-bound). Sums stay in registers and each
// segment's row is written once. Offsets are 64-bit.
//
// What bounds it on the H100: at the ML-20M shape and r = 64 the gathered
// tables are small (Hᵀ 26,744 × 64 × 4 B = 6.8 MB, W 138,493 × 64 × 4 B =
// 35 MB) and live in the 50 MB L2, so the kernel streams vals/cols from
// HBM and gathers rows from L2. Counted over the 20M nonzeros, one SpMM
// must move about 160 MB of vals + cols, the table and an nseg × r × 4 B
// output: about 0.2 GB, 60 µs at 3.35 TB/s. Its 2·nnz·r = 2.6 GFLOP take
// 38 µs at 67 TFLOP/s of float32: bytes bound it. This first kernel
// spends nothing on reaching that bound. Fusing the row scatter, ordering
// segments by width and overlapping the gathers (cp.async / TMA gathers)
// are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;                // row gathers in flight per warp

template <typename T, int VEC> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         T (&x)[VEC]) {
  using V = typename VecOf<T, VEC>::type;
  const V v = __ldg(reinterpret_cast<const V*>(p));
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = e[i];
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const T (&x)[VEC]) {
  using V = typename VecOf<T, VEC>::type;
  V v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = x[i];
  *reinterpret_cast<V*>(p) = v;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Add val · table[col, c0 + (32 p + lane) VEC + i] into acc[p][i] for
// UNROLL (col, val) pairs at once: all gathers are issued before the fmas.
template <typename T, int VEC, int NP, int N>
__device__ __forceinline__ void gather_fma(T (&acc)[NP][VEC],
                                           const T* __restrict__ table,
                                           const int (&col)[N],
                                           const T (&val)[N], int r, int c0,
                                           int lane) {
  T x[N][NP][VEC];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const T* row = table + static_cast<long long>(col[u]) * r;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = c0 + (32 * p + lane) * VEC;
      if (c < r) {
        load_vec<T, VEC>(row + c, x[u][p]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[u][p][i] = T(0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[p][i] = fma_t(val[u], x[u][p][i], acc[p][i]);
}

template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(THREADS)
ell_rowsums_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                   const T* __restrict__ table, T* __restrict__ out,
                   long long nseg, int w, int r) {
  constexpr int TILE = 32 * VEC * NP;    // columns per pass
  const int lane = threadIdx.x & 31;
  const long long nwarps =
      static_cast<long long>(gridDim.x) * WARPS;
  for (long long s = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / 32;
       s < nseg; s += nwarps) {
    const T* sv = vals + s * w;
    const int* sc = cols + s * w;
    for (int c0 = 0; c0 < r; c0 += TILE) {
      T acc[NP][VEC];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[p][i] = T(0);
      for (int kb = 0; kb < w; kb += 32) {
        // lane l holds pair kb + l; every loop bound below is uniform
        // across the warp, so each shuffle has all 32 lanes
        const int k = kb + lane;
        const int my_col = k < w ? sc[k] : 0;
        const T my_val = k < w ? sv[k] : T(0);
        const int nk = w - kb < 32 ? w - kb : 32;
        int j = 0;
        for (; j + UNROLL <= nk; j += UNROLL) {
          int col[UNROLL];
          T val[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            col[u] = __shfl_sync(FULL, my_col, j + u);
            val[u] = __shfl_sync(FULL, my_val, j + u);
          }
          gather_fma<T, VEC, NP, UNROLL>(acc, table, col, val, r, c0, lane);
        }
        for (; j < nk; ++j) {
          int col[1] = {__shfl_sync(FULL, my_col, j)};
          T val[1] = {__shfl_sync(FULL, my_val, j)};
          gather_fma<T, VEC, NP, 1>(acc, table, col, val, r, c0, lane);
        }
      }
      T* so = out + s * r;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = c0 + (32 * p + lane) * VEC;
        if (c < r) store_vec<T, VEC>(so + c, acc[p]);
      }
    }
  }
}

template <typename T, int VEC, int NP>
int launch_t(const T* vals, const int* cols, const T* table, T* out,
             long long nseg, int w, int r, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for every SM several times over; the grid-stride loop
  // takes the rest of a large bucket
  const long long want = (nseg + WARPS - 1) / WARPS;
  const long long cap = 32LL * sms;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  ell_rowsums_kernel<T, VEC, NP><<<grid, THREADS, 0, stream>>>(
      vals, cols, table, out, nseg, w, r);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest vector a row can take (r a multiple of VEC, r >= 32 VEC so no
// lane idles, both pointers aligned to it), then the fewest column groups
// that cover r in one pass (at most 4; wider rows take more passes).
template <typename T>
int launch(const T* vals, const int* cols, const T* table, T* out,
           long long nseg, int w, int r, cudaStream_t stream) {
  auto fits = [&](int vec) {
    const size_t bytes = vec * sizeof(T);
    return vec * sizeof(T) <= 16 && r % vec == 0 && r >= 32 * vec &&
           aligned(table, bytes) && aligned(out, bytes);
  };
  const int vec = fits(4) ? 4 : fits(2) ? 2 : 1;
  const int np = r <= 32 * vec ? 1 : r <= 64 * vec ? 2 : 4;
#define NMFTPU_ELL_CASE(V, P)                                           \
  if (vec == V && np == P)                                              \
    return launch_t<T, V, P>(vals, cols, table, out, nseg, w, r, stream);
  NMFTPU_ELL_CASE(1, 1) NMFTPU_ELL_CASE(1, 2) NMFTPU_ELL_CASE(1, 4)
  NMFTPU_ELL_CASE(2, 1) NMFTPU_ELL_CASE(2, 2) NMFTPU_ELL_CASE(2, 4)
  if constexpr (sizeof(T) == 4) {
    NMFTPU_ELL_CASE(4, 1) NMFTPU_ELL_CASE(4, 2) NMFTPU_ELL_CASE(4, 4)
  }
#undef NMFTPU_ELL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface: vals (nseg, w) and table (m, r) of the entry's type, cols
// (nseg, w) int32 in [0, m), out (nseg, r) of the entry's type; all
// row-major and contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" {

int nmftpu_ell_rowsums_f32(const float* vals, const int* cols,
                           const float* table, float* out, long long nseg,
                           int w, int r, cudaStream_t stream) {
  return launch<float>(vals, cols, table, out, nseg, w, r, stream);
}

int nmftpu_ell_rowsums_f64(const double* vals, const int* cols,
                           const double* table, double* out, long long nseg,
                           int w, int r, cudaStream_t stream) {
  return launch<double>(vals, cols, table, out, nseg, w, r, stream);
}

}  // extern "C"
