// int8 x int8 -> int32 MU numerators for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (nmftpu_torch/kernels/_build.py).
//
//   dual:   nw = Vq Hqᵀ (n, r) and nh = Wqᵀ Vq (r, m) from one stream of
//           V's tiles (replaces nmftpu/kernels/dual_numer.py:128
//           dual_numerators_int8, the Pallas kernel behind Jacobi MU with
//           use_pallas and int8 V);
//   vht:    nw alone, wtv: nh alone (replace the two int8 dot_generals of
//           nmftpu/linalg/dense.py:334 _rhs_vht_int8 and :344
//           _rhs_wtv_int8, which the Gauss–Seidel int8 path runs).
//
// Vq is (n, m), Wq (n, r), Hq (r, m), all int8, row-major, contiguous;
// outputs are int32. Scales are applied by the caller.
//
// Arithmetic: __dp4a (four int8 products summed into an int32 per
// instruction) on the CUDA cores; the operands of each 64-deep slice are
// staged in shared memory as 4-byte words holding four consecutive depth
// values, 4 x 4 outputs per thread. Integer sums are exact and do not
// depend on order, so every entry equals the float64 twin and XLA bit for
// bit; like XLA, a sum past 2^31 wraps modulo 2^32.
//
// What bounds it on the H100: each V element feeds 2r multiply-adds per
// numerator, so at r = 256 int8 V holds 1024 operations per byte, far
// above the int8 tensor cores' 1,979 TOP/s over 3.35 TB/s (about 590):
// operations bound. This first version does not use the tensor cores
// (int8 wgmma with TMA over V's tiles is later work), so its ceiling is
// the dp4a rate and the shared-memory reads that feed it.
//
// The dual entry: a block owns 64 * RB rows of V and 64 factor columns
// [j0, j0 + 64) of r. It streams its rows' V in slices of 64 columns; per
// slice it adds V_sub · Hq[j0:j0+64, slice]ᵀ into the block's nw tile
// (registers, stored once at the end) and forms Wq[rows, j0:j0+64]ᵀ ·
// V_sub for the slice's 64 columns of nh, summed over its RB row
// sub-panels, which it adds into nh with int32 atomicAdd (exact and
// order-free, so the result stays deterministic; zero partial sums are
// skipped, which on sparse ratings skips most). nh must be zeroed by the
// caller. V is read from device memory once per 64 factor columns
// (once at r <= 64); RB = 4 cuts the atomics four-fold where the grid
// stays large enough to fill the card.
//
// Ragged edges: out-of-range operands load as zero, so pad lanes add 0;
// out-of-range outputs are not written. Offsets are 64-bit (n * m may
// exceed 2^31).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;                  // tile extent (elements)
constexpr int BKW = 16;                 // depth per slice, in 4-byte words
constexpr int BK = 4 * BKW;             // depth per slice, in int8 values
constexpr int THREADS = 256;            // 16 x 16 threads, 4 x 4 outputs
constexpr int LDW = BT + 1;             // odd stride: fewer bank conflicts
constexpr int SMS = 132;

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c,
                                     int8_t d) {
  return static_cast<int>(
      static_cast<uint32_t>(static_cast<uint8_t>(a)) |
      static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
      static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
      static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}

// s[kw][i] = the four int8 values at depth k0 + 4 kw .. + 3 of element
// i0 + i, packed little-endian (the layout __dp4a reads). Element (i, k)
// lives at p[i * ld + k] when KCONTIG, else at p[k * ld + i]; consecutive
// threads walk the contiguous index, so the reads coalesce. Values outside
// [0, rows) x [0, depth) are zero.
template <bool KCONTIG>
__device__ __forceinline__ void load_packed(int (*s)[LDW],
                                            const int8_t* __restrict__ p,
                                            long long ld, int i0, int k0,
                                            int rows, int depth) {
#pragma unroll
  for (int t = 0; t < (BKW * BT) / THREADS; ++t) {
    const int e = threadIdx.x + t * THREADS;
    const int kw = KCONTIG ? e % BKW : e / BT;
    const int i = KCONTIG ? e / BKW : e % BT;
    const int gi = i0 + i;
    const int gk = k0 + 4 * kw;
    int word = 0;
    if (gi < rows && gk < depth) {
      if (KCONTIG) {
        const int8_t* q = p + static_cast<long long>(gi) * ld + gk;
        if (gk + 3 < depth && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
          word = *reinterpret_cast<const int*>(q);
        } else {
          word = pack4(q[0], gk + 1 < depth ? q[1] : 0,
                       gk + 2 < depth ? q[2] : 0, gk + 3 < depth ? q[3] : 0);
        }
      } else {
        const int8_t* q = p + static_cast<long long>(gk) * ld + gi;
        word = pack4(q[0], gk + 1 < depth ? q[ld] : 0,
                     gk + 2 < depth ? q[2 * ld] : 0,
                     gk + 3 < depth ? q[3 * ld] : 0);
      }
    }
    s[kw][i] = word;
  }
}

// acc[u][v] += A(ty + 16u) · B(tx + 16v) over one staged slice.
__device__ __forceinline__ void tile_dp4a(int (&acc)[4][4],
                                          const int (*A)[LDW],
                                          const int (*B)[LDW]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int kw = 0; kw < BKW; ++kw) {
    int a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = A[kw][ty + 16 * u];
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = B[kw][tx + 16 * v];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = __dp4a(a[u], b[v], acc[u][v]);
  }
}

// C (rows_a, rows_b) = A Bᵀ over `depth`, C row-major. A block owns the
// 64 x 64 output tile blockIdx.x of a row-major walk over the tiles.
template <bool A_KCONTIG, bool B_KCONTIG>
__global__ void __launch_bounds__(THREADS)
gemm_int8_kernel(const int8_t* __restrict__ A, long long lda, int rows_a,
                 const int8_t* __restrict__ B, long long ldb, int rows_b,
                 int depth, int32_t* __restrict__ C) {
  __shared__ int As[BKW][LDW];
  __shared__ int Bs[BKW][LDW];
  const long long tiles_b = (rows_b + BT - 1) / BT;
  const int i0 = static_cast<int>(blockIdx.x / tiles_b) * BT;
  const int j0 = static_cast<int>(blockIdx.x % tiles_b) * BT;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < depth; k0 += BK) {
    load_packed<A_KCONTIG>(As, A, lda, i0, k0, rows_a, depth);
    load_packed<B_KCONTIG>(Bs, B, ldb, j0, k0, rows_b, depth);
    __syncthreads();
    tile_dp4a(acc, As, Bs);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= rows_a) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < rows_b) C[static_cast<long long>(i) * rows_b + j] = acc[u][v];
    }
  }
}

template <int RB>
__global__ void __launch_bounds__(THREADS)
dual_kernel(const int8_t* __restrict__ V, const int8_t* __restrict__ Wq,
            const int8_t* __restrict__ Hq, int32_t* __restrict__ nw,
            int32_t* __restrict__ nh, int n, int m, int r) {
  __shared__ int Wr[RB][BKW][LDW];   // Wq[rows, j0:+64], packed along rows
  __shared__ int Hc[BKW][LDW];       // Hq[j0:+64, slice], along columns
  __shared__ int Vc[BKW][LDW];       // V sub-tile, packed along columns
  __shared__ int Vr[BKW][LDW];       // the same sub-tile, along rows
  const int i0 = blockIdx.x * (BT * RB);
  const int j0 = blockIdx.y * BT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
    load_packed<false>(Wr[rb], Wq, r, j0, i0 + BT * rb, r, n);
  int acc_w[RB][4][4] = {};
  for (int c0 = 0; c0 < m; c0 += BK) {
    __syncthreads();                 // the last slice's reads are done
    load_packed<true>(Hc, Hq, m, j0, c0, r, m);
    int acc_h[4][4] = {};
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      if (rb > 0) __syncthreads();
      load_packed<true>(Vc, V, m, i0 + BT * rb, c0, n, m);
      load_packed<false>(Vr, V, m, c0, i0 + BT * rb, m, n);
      __syncthreads();
      tile_dp4a(acc_w[rb], Vc, Hc);  // (row, factor column)
      tile_dp4a(acc_h, Wr[rb], Vr);  // (factor column, V column)
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + ty + 16 * u;
      if (j >= r) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + tx + 16 * v;
        if (c < m && acc_h[u][v] != 0)
          atomicAdd(&nh[static_cast<long long>(j) * m + c], acc_h[u][v]);
      }
    }
  }
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + BT * rb + ty + 16 * u;
      if (i >= n) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + tx + 16 * v;
        if (j < r) nw[static_cast<long long>(i) * r + j] = acc_w[rb][u][v];
      }
    }
}

template <bool A_KCONTIG, bool B_KCONTIG>
int launch_gemm(const int8_t* A, long long lda, int rows_a, const int8_t* B,
                long long ldb, int rows_b, int depth, int32_t* C,
                cudaStream_t stream) {
  const long long tiles = static_cast<long long>((rows_a + BT - 1) / BT) *
                          ((rows_b + BT - 1) / BT);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gemm_int8_kernel<A_KCONTIG, B_KCONTIG>
      <<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(
          A, lda, rows_a, B, ldb, rows_b, depth, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every entry launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" {

// out (n, r) = Vq (n, m) · Hq (r, m)ᵀ
int nmftpu_int8_vht(const int8_t* V, const int8_t* Hq, int32_t* out, int n,
                    int m, int r, cudaStream_t stream) {
  return launch_gemm<true, true>(V, m, n, Hq, m, r, m, out, stream);
}

// out (r, m) = Wq (n, r)ᵀ · Vq (n, m)
int nmftpu_int8_wtv(const int8_t* V, const int8_t* Wq, int32_t* out, int n,
                    int m, int r, cudaStream_t stream) {
  return launch_gemm<false, false>(Wq, r, r, V, m, m, n, out, stream);
}

// nw (n, r) = Vq Hqᵀ and nh (r, m) += Wqᵀ Vq; nh zeroed by the caller
int nmftpu_int8_dual(const int8_t* V, const int8_t* Wq, const int8_t* Hq,
                     int32_t* nw, int32_t* nh, int n, int m, int r,
                     cudaStream_t stream) {
  const unsigned gy = (r + BT - 1) / BT;
  if (gy > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks4 = (n + 4 * BT - 1) / (4 * BT);
  if (static_cast<long long>(blocks4) * gy >= 2LL * SMS) {
    dual_kernel<4><<<dim3(blocks4, gy), THREADS, 0, stream>>>(
        V, Wq, Hq, nw, nh, n, m, r);
  } else {
    dual_kernel<1><<<dim3((n + BT - 1) / BT, gy), THREADS, 0, stream>>>(
        V, Wq, Hq, nw, nh, n, m, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
