// Per-row ridged SPD solves of the iALS family for Hopper (sm_90a), one
// launch per half-step, with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py):
//
//     x_i = max(0, (G + dG_i + rho_i I)^-1 rhs_i),
//     rho_i = shift + eps + max(eps, 100 * 2^-23) * tr(G + dG_i) / r
//
// for every row i of one half-step, r <= 128, G (r, r) shared by all rows
// or absent. rho_i is linalg.dense._ridged's ridge, with the same three
// float32 roundings (the mean, the product, the sum); only the trace's
// summation order differs.
//
// Replaces no TPU kernel: nmftpu leaves the per-row solves to XLA's
// batched Cholesky (nmftpu/linalg/dense.py:_batched_solve_clamped), and
// the port's plain path (linalg.dense.row_solver over panels of rows) runs
// linalg.dense.spd_solve: G + dG and the ridge materialized, cuSOLVER's
// batched Cholesky, a triangular solve against the identity and
// Linv^T Linv, about ten passes over every (rows, r, r) panel. Here each
// system is read once (its lower triangle), factored and solved in shared
// memory and registers, and only x_i is written: no inverse and no
// (rows, r, r) intermediate.
//
// Algorithm: a right-looking Cholesky of the system bordered by the
// right-hand side as row R (R = r rounded up to a multiple of 16, the rows
// from r to R an identity block), so the forward substitution y = L^-1 rhs
// runs inside the factorization, then the back substitution L^T x = y. A
// pivot that is not positive and finite makes the whole row NaN, as
// torch.linalg.cholesky_ex's info and spd_solve's `where` do. Float32
// throughout, FMA in the update; no TF32, no reduced precision.
//
// Work split. A block of 256 threads is a 16 x 16 grid; thread t holds
// the entries (ty + 16a, tx + 16b), b <= a < NB = R / 16, ty = t % 16, tx =
// t / 16, in registers (36 at r = 128), so a warp holds two columns of
// each 16 x 16 block. Step k begins with one barrier, after which column k
// of L is in shared memory (rows k..R-1 of a packed column) with 1 /
// sqrt(d_k). The warp holding column k + 1 first brings that column up to
// date, takes its pivot from the owner by a shuffle, scales it by 1 /
// sqrt(pivot) (the hardware estimate and one Newton step) and stores it:
// the next step's data is out before this step's bulk. Then every thread
// updates its entries in the 16-row blocks not yet finished, (NB - kb)(NB
// - kb + 1) / 2 FMAs at step k (kb = k / 16), 1,920 a thread over the 128
// steps at r = 128 against 1,365 for a perfect split. Warp 7 holds the
// bordered row (lane l the entries l + 32t) and updates it after the
// barrier; warp 0 then runs the back substitution from the stored factor
// (a lane owns 4 rows; x_k goes out by a shuffle, the rows above k take
// their FMA) and writes x. Entries of finished rows and columns left in
// registers are updated with stale data and never read again.
//
// Persistent blocks (3 an SM at r = 128) walk the rows. While a block
// factors row s, the next row's lower triangle streams into a staging
// buffer by cp.async (16-byte copies where every row of the system starts
// 16-byte aligned, else 4-byte ones); G, which every row shares, comes from
// L2 as its transpose (a warp's 16 rows of a column are one coalesced
// read) and is added as the staged triangle moves to registers, where the
// trace is summed and rho put on the diagonal. The stage's rows start at
// 4 (h (2g + 3) mod 8) (mod 32) floats for row 8g + h, so a warp's 16 rows
// of two columns take two shared-memory wavefronts. Shared memory at r =
// 128: the stage 36.9 KB, the factor's packed columns 33.5 KB, 1 /
// sqrt(d), y and the trace's partial sums.
//
// What bounds it on the H100: (n + m) (r^3 / 3 + 2 r^2) operations, 1.15e11
// an iteration at ML-20M clicks' 156,785 rows and r = 128, 1.7 ms at 67
// TFLOP/s of float32; the lower triangles' 5.18 GB, 1.55 ms at 3.35 TB/s.
// What sets the pace is latency: on an H100 at 700 W (clock64 timelines
// of one block) a step takes about 400-600 cycles however little it
// computes, and a row about 100,000 cycles with its loads (15,000) and
// back substitution (7,000); the three blocks of an SM hide each other's
// waits almost fully (one block an SM runs 2.8 times slower). Deferring
// the rank-16 updates to the end of each 16-column panel, two columns a
// step, 16-byte reads of a permuted copy of each column, and streaming
// the next row in a row a step all made it slower on that card.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

using nmftpu_tc::cp_async;
using nmftpu_tc::cp_async_commit;
using nmftpu_tc::cp_async_wait;
using nmftpu_tc::smem_u32;

constexpr int THREADS = 256;             // a 16 x 16 grid (ty, tx)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NB = 8;                // r <= 16 * MAX_NB = 128
constexpr unsigned FULL = 0xffffffffu;

// Row i = 8g + h of a staged lower triangle starts at float 32 g^2 + 64 g
// + h (8g + 12) and has 8g + 12 floats: its i + 1 entries rounded up to
// whole 16-byte copies, and padding that puts row h of every group of 8
// at 4 (h (2g + 3) mod 8) (mod 32).
__host__ __device__ constexpr int stage_row(int i) {
  return 32 * (i >> 3) * (i >> 3) + 64 * (i >> 3) +
         (i & 7) * (8 * (i >> 3) + 12);
}

// Column k of the factor holds rows k..R-1 from float col_start(k, R) on.
__host__ __device__ constexpr int col_start(int k, int R) {
  return R * k - k * (k - 1) / 2;
}

// A thread's entry (ty + 16a, tx + 16b), b <= a, in its register array
__host__ __device__ constexpr int tri(int a, int b) {
  return a * (a + 1) / 2 + b;
}

template <int NB>
struct Layout {
  static constexpr int R = 16 * NB;
  static constexpr int T = (R + 31) / 32;         // entries a lane, 1 x R
  static constexpr int STAGE = stage_row(R);      // floats
  static constexpr int FACTOR = col_start(R, R);  // floats
  // the stage, the factor, 1 / sqrt(d), y, the trace's 16 partial sums
  static constexpr size_t BYTES =
      sizeof(float) * (STAGE + FACTOR + 2 * R + 16);
};

// Stage the lower triangle of one system (r rows of r floats) by
// cp.async: row i's first i + 1 entries, as 16-byte copies (vec4: r % 4 ==
// 0 and the system 16-byte aligned, so a row's rounded-up copies stay in
// it) or 4-byte ones. A warp takes every 8th row.
__device__ __forceinline__ void stage_system(float* stage, const float* sys,
                                             int r, bool vec4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(stage);
  for (int i = warp; i < r; i += WARPS) {
    const float* src = sys + static_cast<long long>(i) * r;
    const uint32_t dst = base + 4u * stage_row(i);
    if (vec4) {
      if (lane <= (i >> 2)) cp_async<16>(dst + 16u * lane, src + 4 * lane, 16);
    } else {
      for (int j = lane; j <= i; j += 32) cp_async<4>(dst + 4u * j, src + j, 4);
    }
  }
}

// 1 / sqrt(d) to about an ulp: the hardware estimate and one Newton step.
// d not positive or not finite gives NaN.
__device__ __forceinline__ float rsqrt_newton(float d) {
  const float s = rsqrtf(d);
  return fmaf(0.5f * s, fmaf(-d * s, s, 1.f), s);
}

// Column k of the factor to shared memory, run by the warp holding it
// (tx = k % 16): its pivot v[kb] from lane 16 (k % 2) + k % 16 by a
// shuffle, then rows k..R-1 (entries v[a], a >= kb = k / 16, of the
// threads tx = k % 16) times 1 / sqrt(pivot), and that scale.
template <int NB>
__device__ __forceinline__ void put_column(float* fac, float* sinv,
                                           const float (&v)[NB], int k,
                                           int tx, int ty) {
  constexpr int R = 16 * NB;
  const int kb = k >> 4, c = k & 15;
  const float s = rsqrt_newton(__shfl_sync(FULL, v[kb], 16 * (c & 1) + c));
  if (tx == c) {
    float* col = fac + (col_start(k, R) - k);
#pragma unroll
    for (int a = 0; a < NB; ++a)
      if (a >= kb && ty + 16 * a >= k) col[ty + 16 * a] = v[a] * s;
    if (ty == c) sinv[k] = s;
  }
}

// Gt: G transposed (r, r) contiguous, or null; dG: rows systems of r x r
// floats, ld_g floats apart; rhs: rows of r floats, ld_rhs apart; out
// (rows, r) contiguous.
template <int NB>
__global__ void __launch_bounds__(THREADS, 3)
row_chol_solve_kernel(const float* __restrict__ Gt,
                      const float* __restrict__ dG,
                      const float* __restrict__ rhs, float* __restrict__ out,
                      long long rows, int r, long long ld_g,
                      long long ld_rhs, float c0, float c1, bool vec4) {
  using Lay = Layout<NB>;
  constexpr int R = Lay::R, T = Lay::T;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* fac = stage + Lay::STAGE;
  float* sinv = fac + Lay::FACTOR;        // 1 / sqrt(d_k)
  float* yv = sinv + R;                   // y = L^-1 rhs
  float* part = yv + R;
  const int ty = threadIdx.x & 15, tx = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  long long s = blockIdx.x;
  if (s < rows) stage_system(stage, dG + s * ld_g, r, vec4);
  cp_async_commit();
  for (; s < rows; s += gridDim.x) {
    cp_async_wait<0>();
    // the stage is in; the previous row's back solve is done with fac
    __syncthreads();

    // G + dG's lower triangle (an identity block beyond r), the bordered
    // row in warp 7, and the diagonal's partial sums
    float A[tri(NB, 0)];
    float B[T];
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int j = tx + 16 * b;
        float v = i == j ? 1.f : 0.f;
        if (i < r && j <= i) {
          v = stage[stage_row(i) + j];
          if (Gt != nullptr) v = __fadd_rn(v, __ldg(Gt + j * r + i));
        }
        A[tri(a, b)] = v;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = lane + 32 * t;
      B[t] = warp == WARPS - 1 && j < r ? __ldg(rhs + s * ld_rhs + j) : 0.f;
    }
    if (ty == tx) {
      float p = 0.f;
#pragma unroll
      for (int a = 0; a < NB; ++a)
        if (ty + 16 * a < r) p = __fadd_rn(p, A[tri(a, a)]);
      part[ty] = p;
    }
    // the stage is free for the next row; the partial sums are in
    __syncthreads();
    if (s + gridDim.x < rows)
      stage_system(stage, dG + (s + gridDim.x) * ld_g, r, vec4);
    cp_async_commit();

    float tr = 0.f;
#pragma unroll
    for (int p = 0; p < 16; ++p) tr = __fadd_rn(tr, part[p]);
    const float rho = __fadd_rn(
        c0, __fmul_rn(c1, __fdiv_rn(tr, static_cast<float>(r))));
    if (ty == tx) {
#pragma unroll
      for (int a = 0; a < NB; ++a)
        if (ty + 16 * a < r) A[tri(a, a)] = __fadd_rn(A[tri(a, a)], rho);
    }

    // the bordered Cholesky, column k at step k; column 0 first
    if (warp == 0) {
      float v[NB];
#pragma unroll
      for (int a = 0; a < NB; ++a) v[a] = A[tri(a, 0)];
      put_column<NB>(fac, sinv, v, 0, tx, ty);
    }
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int k = 16 * kb + c;
        const float* col = fac + (col_start(k, R) - k);   // col[i]: row i
        // column k and 1 / sqrt(d_k) are in
        __syncthreads();
        float lr[NB], lc[NB];
#pragma unroll
        for (int a = kb; a < NB; ++a) lr[a] = col[ty + 16 * a];
#pragma unroll
        for (int b = kb; b < NB; ++b) lc[b] = col[tx + 16 * b];
        // look ahead: the warp holding column k + 1 brings it up to date
        // and stores it before the others' updates, which compute the
        // same FMAs again
        const int k1 = k + 1, kb1 = k1 >> 4;
        if (k1 < R && warp == ((k1 & 15) >> 1)) {
          float v[NB];
#pragma unroll
          for (int a = kb1; a < NB; ++a)
            v[a] = fmaf(-lr[a], lc[kb1], A[tri(a, kb1)]);
          put_column<NB>(fac, sinv, v, k1, tx, ty);
        }
        if (warp == WARPS - 1) {
          // y_k = (rhs_k - sum_{j<k} y_j L_kj) / L_kk, then the bordered
          // row's later entries lose y_k L_jk
          const float y = __shfl_sync(FULL, B[k >> 5], k & 31) * sinv[k];
#pragma unroll
          for (int t = 0; t < T; ++t)
            if (lane + 32 * t < R) B[t] = fmaf(-y, col[lane + 32 * t], B[t]);
          if (lane == (k & 31)) yv[k] = y;
        }
#pragma unroll
        for (int a = kb; a < NB; ++a)
#pragma unroll
          for (int b = kb; b <= a; ++b)
            A[tri(a, b)] = fmaf(-lr[a], lc[b], A[tri(a, b)]);
      }
    }
    // y is in
    __syncthreads();

    // back substitution by warp 0: lane l owns rows l + 32t; z starts at y
    // and loses L_ki x_k for each k > i; x_i = z_i / L_ii
    if (warp == 0) {
      float z[T], si[T];
      bool bad = false;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int i = lane + 32 * t;
        z[t] = 0.f;
        si[t] = 0.f;
        if (i < R) {
          si[t] = sinv[i];
          z[t] = yv[i];
          bad |= !(si[t] > 0.f && si[t] <= 3.402823466e38f);
        }
      }
      bad = __any_sync(FULL, bad);
#pragma unroll
      for (int t = T - 1; t >= 0; --t) {
#pragma unroll
        for (int l = 31; l >= 0; --l) {
          const int k = 32 * t + l;
          if (k >= R) continue;
          const float xk = __shfl_sync(FULL, z[t] * si[t], l);
#pragma unroll
          for (int u = 0; u <= t; ++u) {
            const int i = lane + 32 * u;
            if (i < k)
              z[u] = fmaf(-fac[col_start(i, R) - i + k], xk, z[u]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int i = lane + 32 * t;
        if (i < r) {
          const float x = z[t] * si[t];
          out[s * r + i] = bad ? __int_as_float(0x7fc00000)
                               : (x < 0.f ? 0.f : x);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- host side -------------------------------------------------------------

template <int NB>
int launch_nb(const float* Gt, const float* dG, const float* rhs,
              float* out, long long rows, int r, long long ld_g,
              long long ld_rhs, float c0, float c1, cudaStream_t stream) {
  const auto kernel = row_chol_solve_kernel<NB>;
  const size_t bytes = Layout<NB>::BYTES;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(rows < cap ? rows : cap);
  const bool vec4 = r % 4 == 0 && ld_g % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dG) % 16 == 0;
  kernel<<<grid, THREADS, bytes, stream>>>(Gt, dG, rhs, out, rows, r, ld_g,
                                           ld_rhs, c0, c1, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// #12: out (rows, r) = max(0, (G + dG_i + rho_i I)^-1 rhs_i) per row, rho_i
// = c0 + c1 tr(G + dG_i) / r (c0 = shift + eps, c1 = max(eps, 100 * 2^-23)
// as float32); a row whose factorization meets a pivot that is not
// positive and finite is NaN. Gt: G's transpose (r, r) contiguous, or
// null; dG_i the r x r floats at dG + i * ld_g (ld_g >= r * r), read below
// and on the diagonal only; rhs_i the r floats at rhs + i * ld_rhs; 1 <= r
// <= 128. Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape it cannot take.
int nmftpu_row_solve_f32(const float* Gt, const float* dG, const float* rhs,
                         float* out, long long rows, int r, long long ld_g,
                         long long ld_rhs, float c0, float c1,
                         cudaStream_t stream) {
  if (rows < 0 || r < 1 || r > 16 * MAX_NB ||
      ld_g < static_cast<long long>(r) * r || ld_rhs < r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  using Launch = int (*)(const float*, const float*, const float*, float*,
                         long long, int, long long, long long, float, float,
                         cudaStream_t);
  static const Launch by_nb[MAX_NB] = {launch_nb<1>, launch_nb<2>,
                                       launch_nb<3>, launch_nb<4>,
                                       launch_nb<5>, launch_nb<6>,
                                       launch_nb<7>, launch_nb<8>};
  return by_nb[(r + 15) / 16 - 1](Gt, dG, rhs, out, rows, r, ld_g, ld_rhs,
                                  c0, c1, stream);
}

}  // extern "C"
