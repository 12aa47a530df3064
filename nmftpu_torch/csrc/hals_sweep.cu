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
// result goes to a separate (n, r) buffer. Per block of b <= 16 columns
// starting at s (the last block shorter when b does not divide r, exactly
// as linalg.dense._hals_half_sweep_blocked): the gradient base
// W · G[:, s:s+b] - XHt[:, s:s+b], then a b-step chain in which each new
// column shifts the later columns' bases by delta · G[s+j, s+t] (rank-1
// corrections).
//
// What bounds it on the H100: about 2 n r^2 + 2 n r b operations on
// 3 n r float32 values read or written (at 4096 x 256, 0.57 GFLOP and
// 12.6 MB): on the float32 CUDA cores (67 TFLOP/s) against HBM
// (3.35 TB/s), operations bound at 8.5 us. The first version of this file
// held one row per warp and summed each base in one chain of r/2
// dependent fmaf, both operands read from shared memory, with G's panel
// restaged behind two barriers by each 8-row block: 3.2 TFLOP/s, and all
// of G read from L2 by n/8 blocks.
//
// Design. A block owns TR rows of W (32 at r = 256, fewer where they
// would fill fewer than 128 blocks or where the rows do not fit shared
// memory) for the whole sweep, in shared memory, so G is read n/TR times,
// not n/8. G's (r x 16) column panels stream through a two-buffer
// cp.async ring in chunks of 256 rows of G, with the (b x b) diagonal
// block beside each column block's first chunk: the next panel loads
// while this one's base and chain run. The base is a (TR x 16) product of
// depth r on the CUDA cores: each thread owns a 4 x 4 tile of it (16
// independent accumulators, eight 16-byte shared-memory reads per 64
// fmaf) over the depth quads q = ks (mod KS), KS = 256 / TR slices of the
// depth, each quad's four depths in order; the slices' partial sums meet
// in shared memory and are added in slice order, so the result is
// deterministic (no atomics), and no chain of sums is longer than r / KS.
// The chain keeps 16 lanes a row (a column of the block each, base by
// shuffle), two rows a thread at TR = 32, with the hess = 0 skip
// (sklearn's semantics); everything it reads that does not depend on it
// is loaded first, and it multiplies by the hessian's rounded reciprocal,
// max(fmaf(-grad, 1/hess, old), 0), where the blocked sweep divides: a
// step is then a shuffle and four float operations. What holds it back
// (chip_ablate.py, 4096 x 256): one block of 8 warps an SM, so each
// phase's latency is exposed, and the 256 chain steps in a row; 16 or 8
// rows a block (2-3 blocks an SM) were no faster.
// Sums are float32 in another order than the plain blocked sweep:
// agreement is to roundoff, which the clamp and the division by the
// hessian can amplify (the tests and chip_smoke.py hold it to
// 3e-5 * max|W|, the bound nmftpu's own tests put on its Pallas sweep;
// tests/test_torch_hals.py models this order on the CPU).

#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

using nmftpu_tc::cp_async;
using nmftpu_tc::cp_async_commit;
using nmftpu_tc::cp_async_wait;
using nmftpu_tc::smem_u32;

constexpr int THREADS = 256;
constexpr int MAXB = 16;        // widest column block
constexpr int KCH = 256;        // rows of G in one panel chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;
// panels [2][KCH][MAXB], diagonal blocks [2][MAXB][MAXB], the slices'
// partial bases [THREADS][16], the reciprocal hessians [MAXB], then W's
// rows [TR][w_stride(r)]
constexpr size_t FIXED =
    sizeof(float) * (2 * KCH * MAXB + 2 * MAXB * MAXB + THREADS * 16 + MAXB);

// W's rows in shared memory: row-major, padded to whole 16-byte quads and
// to 4 (mod 8) quads, so that rows 4 apart (neighbouring threads' tiles)
// start 64 bytes apart in the banks
__host__ __device__ inline int w_stride(int r) {
  const int r4 = (r + 3) / 4 * 4;
  return r4 % 8 == 0 ? r4 + 4 : r4;
}

template <int TR>
__global__ void __launch_bounds__(THREADS)
hals_sweep_kernel(const float* __restrict__ XHt, const float* __restrict__ G,
                  const float* __restrict__ W, float* __restrict__ out,
                  int n, int r, int block) {
  constexpr int KS = THREADS / TR;             // depth slices
  constexpr int RPT = TR >= 16 ? TR / 16 : 1;  // chain rows a thread
  extern __shared__ __align__(16) float smem[];
  float* panel = smem;                      // [2][KCH][MAXB]
  float* gbb = panel + 2 * KCH * MAXB;      // [2][MAXB][MAXB]
  float* red = gbb + 2 * MAXB * MAXB;       // [KS][TR][MAXB]
  float* rhs = red + THREADS * 16;         // [MAXB]
  float* Ws = rhs + MAXB;                   // [TR][ldw]
  const int ldw = w_stride(r);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TR;

  for (int e = tid; e < TR * ldw; e += THREADS) {
    const int row = e / ldw, k = e % ldw;
    Ws[e] = k < r && row0 + row < n ? W[(row0 + row) * r + k] : 0.f;
  }

  const int nch = (r + KCH - 1) / KCH;
  const int nblk = (r + block - 1) / block;
  const int stages = nblk * nch;
  // stage i: column block i / nch, chunk i % nch of G's rows (zero to the
  // next whole quad); the block's first chunk brings its diagonal block
  auto issue = [&](int i) {
    if (i < stages) {
      const int cb = i / nch, c = i % nch;
      const int s = cb * block, b = min(block, r - s);
      const int k0 = c * KCH, kc = min(KCH, r - k0);
      // this thread's column of the panel, every 16th row from its own
      const int col = tid % MAXB;
      const float* src = G + static_cast<long long>(k0 + tid / MAXB) * r + s +
                         col;
      uint32_t dst = smem_u32(panel + (i & 1) * KCH * MAXB + tid);
      for (int kk = tid / MAXB; kk < (kc + 3) / 4 * 4;
           kk += THREADS / MAXB, src += (THREADS / MAXB) * r,
           dst += THREADS * sizeof(float)) {
        const bool ok = kk < kc && col < b;
        cp_async<4>(dst, ok ? src : G, ok ? 4 : 0);
      }
      if (c == 0) {
        float* d = gbb + (cb & 1) * MAXB * MAXB;
        for (int e = tid; e < MAXB * MAXB; e += THREADS) {
          const int j = e / MAXB, col = e % MAXB;
          const bool ok = j < b && col < b;
          cp_async<4>(smem_u32(d + e),
                      ok ? G + static_cast<long long>(s + j) * r + s + col
                         : G, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // the base's thread tile: rows 4 rq + [0, 4), columns 4 cq + [0, 4),
  // the depth quads q = ks (mod KS)
  const int u = tid % TR, ks = tid / TR;
  const int rq = u / 4, cq = u % 4;
  // the chain's lane: column t of the block, rows g + 16 q
  const int t = tid % 16, g = tid / 16;
  int crow[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) crow[q] = min(g + 16 * q, TR - 1);
  const bool chain_rows = g < TR;

  issue(0);
  int i = 0;
  for (int cb = 0; cb < nblk; ++cb) {
    const int s = cb * block, b = min(block, r - s);
    float xht[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const long long row = row0 + g + 16 * q;
      xht[q] = chain_rows && row < n && t < b ? XHt[row * r + s + t] : 0.f;
    }
    float acc[4][4] = {};
    for (int c = 0; c < nch; ++c, ++i) {
      issue(i + 1);                 // its buffer's last readers are done
      cp_async_wait<1>();
      __syncthreads();              // stage i is in, for every thread
      const float* p = panel + (i & 1) * KCH * MAXB;
      const int k0 = c * KCH;
      const int quads = (min(r, k0 + KCH) - k0 + 3) / 4;
      for (int q = ks; q < quads; q += KS) {
        float wr[4][4], gc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 w = *reinterpret_cast<const float4*>(
              Ws + (4 * rq + a) * ldw + k0 + 4 * q);
          wr[a][0] = w.x; wr[a][1] = w.y; wr[a][2] = w.z; wr[a][3] = w.w;
          const float4 gv = *reinterpret_cast<const float4*>(
              p + (4 * q + a) * MAXB + 4 * cq);
          gc[a][0] = gv.x; gc[a][1] = gv.y; gc[a][2] = gv.z; gc[a][3] = gv.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)         // depth k0 + 4 q + j, in order
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[a][e] = fmaf(wr[a][j], gc[j][e], acc[a][e]);
      }
      __syncthreads();              // stage i's buffer may be refilled
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(red + (ks * TR + 4 * rq + a) * 16 + 4 * cq) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    const float* d = gbb + (cb & 1) * MAXB * MAXB;
    if (tid < MAXB) {               // the block's reciprocal hessians, once
      const float h = d[tid * MAXB + tid];
      rhs[tid] = h != 0.f ? __frcp_rn(h) : 0.f;
    }
    __syncthreads();

    // the chain; every thread runs it (the shuffles need whole warps),
    // threads past the tile's rows on a copy of its last row. All that
    // does not depend on the chain is loaded first: the diagonal block's
    // row j at this lane's column, the reciprocal hessians (0 where the
    // hessian is, the column then kept) and the old values, so each step
    // is a shuffle, two fmaf, a max and a subtraction.
    float gj[MAXB], rh[MAXB], old[RPT][MAXB], base[RPT], mine[RPT];
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      live |= (d[j * MAXB + j] != 0.f ? 1u : 0u) << j;
      rh[j] = rhs[j];
      gj[j] = d[j * MAXB + t];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        old[q][j] = j < b ? Ws[crow[q] * ldw + s + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      float sum = 0.f;              // the slices in order
      for (int z = 0; z < KS; ++z) sum += red[(z * TR + crow[q]) * 16 + t];
      base[q] = sum - xht[q];
      mine[q] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      if (j < b) {
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const float grad = __shfl_sync(FULL, base[q], j, 16);
          const float nv = (live >> j) & 1u
              ? fmaxf(fmaf(-grad, rh[j], old[q][j]), 0.f) : old[q][j];
          if (t == j) mine[q] = nv;
          base[q] = fmaf(nv - old[q][j], gj[j], base[q]);
        }
      }
    }
    // each row's 16 lanes are one converged half-warp: all have read
    // the row's old values
    if (chain_rows && t < b)
#pragma unroll
      for (int q = 0; q < RPT; ++q) Ws[(g + 16 * q) * ldw + s + t] = mine[q];
    __syncthreads();
  }
  cp_async_wait<0>();

  for (int e = tid; e < TR * r; e += THREADS) {
    const int row = e / r, k = e % r;
    if (row0 + row < n) out[(row0 + row) * r + k] = Ws[row * ldw + k];
  }
}

template <int TR>
size_t smem_bytes(int r) {
  return FIXED + sizeof(float) * TR * static_cast<size_t>(w_stride(r));
}

template <int TR>
int launch(const float* XHt, const float* G, const float* W, float* out,
           int n, int r, int block, cudaStream_t stream) {
  const size_t bytes = smem_bytes<TR>(r);
  cudaError_t err = cudaFuncSetAttribute(
      hals_sweep_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + TR - 1) / TR);
  hals_sweep_kernel<TR><<<blocks, THREADS, bytes, stream>>>(XHt, G, W, out,
                                                            n, r, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n, r) = one HALS half-sweep of W (n, r) against XHt (n, r) and the
// Gram G (r, r), in column blocks of `block` (1..16). Rows a block: the
// most of 32, 16, 8, 4 that fit shared memory and still make 128 blocks,
// else the fewest that fit (r <= 11,324). Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a block
// width or rank it cannot take.
int nmftpu_hals_sweep_f32(const float* XHt, const float* G, const float* W,
                          float* out, int n, int r, int block,
                          cudaStream_t stream) {
  if (block < 1 || block > MAXB || r < 1 || n < 1 ||
      smem_bytes<4>(r) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fits = [&](size_t bytes, int tr) {
    return bytes <= SMEM_MAX && (n + tr - 1) / tr >= 128;
  };
  if (fits(smem_bytes<32>(r), 32))
    return launch<32>(XHt, G, W, out, n, r, block, stream);
  if (fits(smem_bytes<16>(r), 16))
    return launch<16>(XHt, G, W, out, n, r, block, stream);
  if (fits(smem_bytes<8>(r), 8))
    return launch<8>(XHt, G, W, out, n, r, block, stream);
  return launch<4>(XHt, G, W, out, n, r, block, stream);
}

}  // extern "C"
