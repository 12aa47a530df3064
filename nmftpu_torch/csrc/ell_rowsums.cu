// ELL sparse-times-dense product for Hopper (sm_90a), one launch per
// product, with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py):
//
//     out[rows[s], :] += Σ_{k < w} vals[s, k] · table[cols[s, k], :]
//
// for every padded segment s of up to MAX_BUCKETS ELL buckets at once,
// into a zeroed (n, r) out: V·Hᵀ from the row container, (Wᵀ·V)ᵀ from the
// transposed one.
//
// Replaces the TPU kernel nmftpu/kernels/sparse_ell_kernel.py:98
// bucket_rowsums_pallas (kernel _make_seg_rowsum_kernel :58, pallas_call
// :140), and the scatter of segment sums into rows that nmftpu leaves to
// XLA: here each segment's sum goes straight into its row, so the (nseg,
// r) segment sums never reach device memory. The TPU's VMEM table budget,
// one-step grid and scan over segment groups are not carried over.
// Segment sums alone (bucket_rowsums) are the same launch with rows[s] =
// s.
//
// Precision contract: a template over float and double that multiplies
// and accumulates in the element type, fma in k order over the segment's
// lanes with a nonzero value. Skipping a zero lane changes nothing for a
// finite table (fma(0, x, acc) = acc), so a row with one segment gets the
// bits the k-ordered sum of all lanes gives. A row with several segments
// adds them with atomics, in an order that changes from run to run, as
// index_add_ on CUDA does. Against the plain twin (another summation
// order) the relative error is about sqrt(w) · 2^-24 in float32 on
// nonnegative data (w <= 512).
//
// Work split. Buckets come widest first (the wrapper orders them), so the
// 512-wide segments start first and do not form the tail. A warp takes
// two consecutive segments at a time, one per half-warp of 16 lanes, in a
// grid-stride walk over the segments of all buckets. A half-warp reads its
// segment's (col, val) pairs 16 at a time (coalesced); a warp ballot on
// val != 0 leaves only the nonzero lanes, so pad lanes and all-zero pad
// segments cost only that read. Each nonzero pair is broadcast by a
// shuffle, and lane l of the half gathers VEC contiguous columns in each
// of NP 16·VEC-column groups of the table row: at r = 64 one float4 a
// lane, so a row is one coalesced 256 B read. Up to 8 row gathers are
// in flight per half-warp (8 / NP pairs), 16 per warp. Sums stay in
// registers; the half then adds them into out[rows[s]] with vector
// atomics (float4 / float2 on sm_90, double as two scalars). Rows wider
// than 16·VEC·NP columns take several passes. Offsets are 64-bit.
//
// What bounds it on the H100: at the ML-20M shape and r = 64 the gathered
// tables (Hᵀ 26,744 × 64 × 4 B = 6.8 MB, W 138,493 × 64 × 4 B = 35 MB)
// fit the 50 MB L2, so the kernel streams vals/cols from HBM and gathers
// rows from L2. Counted over the 20M nonzeros, one product must move about
// 160 MB of vals + cols, the table and the output: 0.2 GB, 60 µs at 3.35
// TB/s, while its 2·nnz·r = 2.6 GFLOP take 38 µs at 67 TFLOP/s of float32.
// The gathers themselves are nnz · r · 4 B = 5.1 GB of L2 traffic a
// product, which at the L2's rate (several TB/s) is the realistic floor.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HALF = 16;                 // lanes per segment
constexpr int MAX_BUCKETS = 8;
constexpr int GATHERS = 8;               // row loads in flight per lane

template <typename T>
struct Bucket {
  const T* vals;        // (nseg, w)
  const int* cols;      // (nseg, w)
  const int* rows;      // (nseg,)
  long long first;      // index of its first segment among all buckets
  int w;
};

template <typename T>
struct Plan {
  Bucket<T> b[MAX_BUCKETS];
  long long nseg;       // segments of all buckets
  int nb;
};

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

// out[0, VEC) += x, atomically
template <typename T, int VEC>
__device__ __forceinline__ void add_vec(T* p, const T (&x)[VEC]) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2],
                                                        x[3]));
  } else if constexpr (sizeof(T) == 4 && VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(p + i, x[i]);
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const __grid_constant__ Plan<T> plan,
                const T* __restrict__ table, T* __restrict__ out, int r) {
  constexpr int TILE = HALF * VEC * NP;  // columns per pass
  constexpr int U = GATHERS / NP;        // pairs gathered at once
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int hl = lane & (HALF - 1);
  const long long tasks = (plan.nseg + 1) / 2;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / 32;
       t < tasks; t += nwarps) {
    const long long s = 2 * t + half;   // this half's segment
    Bucket<T> bk = plan.b[0];
#pragma unroll
    for (int i = 1; i < MAX_BUCKETS; ++i)
      if (i < plan.nb && s >= plan.b[i].first) bk = plan.b[i];
    const bool live = s < plan.nseg;
    const long long ls = s - bk.first;  // the segment within its bucket
    const int w = live ? bk.w : 0;
    const T* sv = bk.vals + ls * bk.w;
    const int* sc = bk.cols + ls * bk.w;
    // both halves run every loop below the same number of times, so each
    // shuffle and ballot has all 32 lanes
    const int wmax = max(w, __shfl_xor_sync(FULL, w, HALF));
    for (int c0 = 0; c0 < r; c0 += TILE) {
      T acc[NP][VEC];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[p][i] = T(0);
      bool any = false;
      for (int kb = 0; kb < wmax; kb += HALF) {
        const int k = kb + hl;
        const int my_col = k < w ? sc[k] : 0;
        const T my_val = k < w ? sv[k] : T(0);
        unsigned bits = (__ballot_sync(FULL, my_val != T(0)) >>
                         (HALF * half)) & 0xffffu;
        const int nk = __popc(bits);
        const int nmax = max(nk, __shfl_xor_sync(FULL, nk, HALF));
        any |= nk > 0;
        for (int j = 0; j < nmax; j += U) {
          // the next U nonzero lanes of this half, in k order
          int col[U];
          T val[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int src = bits ? __ffs(bits) - 1 : 0;
            bits &= bits - 1;
            col[u] = __shfl_sync(FULL, my_col, HALF * half + src);
            val[u] = __shfl_sync(FULL, my_val, HALF * half + src);
          }
          T x[U][NP][VEC];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const T* row = table + static_cast<long long>(col[u]) * r;
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const int c = c0 + (HALF * p + hl) * VEC;
              if (j + u < nk && c < r) {
                load_vec<T, VEC>(row + c, x[u][p]);
              } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) x[u][p][i] = T(0);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j + u >= nk) break;
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                acc[p][i] = fma_t(val[u], x[u][p][i], acc[p][i]);
          }
        }
      }
      if (!any) continue;               // nothing to add: a pad segment
      T* so = out + static_cast<long long>(bk.rows[ls]) * r;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = c0 + (HALF * p + hl) * VEC;
        if (c < r) add_vec<T, VEC>(so + c, acc[p]);
      }
    }
  }
}

// #11: the MU-KL half-step's numerator over a whole ELL container, one
// launch:
//
//     out[rows[s], :] += Σ_{k < w} c_k · table[cols[s, k], :],
//     c_k = vals[s, k] / (<own[rows[s], :], table[cols[s, k], :]> + eps)
//
// into a zeroed (n, r) out: W's numerator from the row container (own W,
// table Hᵀ), (Hᵀ's numerator) from the transposed one (own Hᵀ, table W).
// It replaces no TPU kernel: nmftpu leaves this step (sparse_ell.py,
// mu_update_kl_ell) to XLA's gathers and einsums. Fused here, each table
// row is gathered once and serves both the sample and the sum, and
// neither the (block, w, r) gathered rows nor the segment sums reach
// device memory.
//
// Work split as in ell_spmm_kernel: half a warp a segment, (col, val)
// read 16 at a time, a ballot that keeps the lanes with val != 0, up to
// 4 row gathers in flight a half-warp. The half loads own[rows[s]] into
// registers once; lane l holds VEC contiguous columns in each of NP
// 16·VEC-column groups, so a row of up to 16·VEC·NP columns (64 bytes a
// lane: r <= 256 in float32, 128 in float64) is covered in one pass and
// the caller takes wider rows elsewhere. Each lane forms its slice's
// partial dots with the U gathered rows; a 4-step xor reduction inside
// the half finishes them, transposed (a lane keeps half its partials at
// each of the first log2(U) steps and trades the rest), so that each lane
// ends with one whole dot, computes one c = v / (s + eps), the plain
// twin's formula, and a shuffle hands the U coefficients back. Then acc
// = fma(c, x, acc) in k order. The half adds acc into out[rows[s]] with
// vector atomics.
//
// Precision contract: as ell_spmm_kernel, in the element type (float or
// double): the dot in a fixed order (each lane's columns in order, then
// the reduction tree over the 16 lanes), the sum fma in k order over the
// lanes with a nonzero value, several segments of a row added by atomics
// in no fixed order. Skipping a zero lane changes nothing wherever
// s + eps != 0 (its c is 0). With eps = 0 a pad lane (col 0, val 0) whose
// sample s is 0 gives 0/0 = NaN in the plain twin, which then spreads
// over the row; the kernel skips the lane and keeps the row finite.
//
// What bounds it on the H100: the same gathers as one ell_spmm product,
// nnz · r · 4 B = 5.1 GB of L2 traffic a half-step at ML-20M and r = 64
// (both tables fit the 50 MB L2), for twice the arithmetic (4·nnz·r:
// the dot and the sum), about two shuffles a nonzero more than #10 at
// r <= 64 (U = 4: 9 shuffles for 4 rows) and one division a lane for
// every U nonzeros.
//
// #11 keeps fewer rows in flight than #10 and asks for more resident
// blocks: the sample's reduction and division lengthen each lane's chain,
// so more warps, not more loads a warp, hide the gathers. On the H100 at
// ML-20M and r = 64, 4 rows and 4 blocks of 64 registers a thread take
// 0.77 ms a half-step, 8 rows and 2 blocks of 107 registers 1.30 ms.
// Rows wider than 16 bytes a lane keep 2 blocks, to spill little.
constexpr int KL_GATHERS = 4;

template <typename T, int VEC, int NP>
constexpr int kl_min_blocks() {
  return VEC * NP * sizeof(T) <= 16 ? 4 : 2;
}

template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(THREADS, kl_min_blocks<T, VEC, NP>())
ell_kl_kernel(const __grid_constant__ Plan<T> plan, const T* __restrict__ own,
              const T* __restrict__ table, T* __restrict__ out, int r,
              T eps) {
  constexpr int U = KL_GATHERS / NP > 0 ? KL_GATHERS / NP : 1;  // rows
  constexpr int LOG_U = U >= 8 ? 3 : U >= 4 ? 2 : U >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int hl = lane & (HALF - 1);
  const long long tasks = (plan.nseg + 1) / 2;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / 32;
       t < tasks; t += nwarps) {
    const long long s = 2 * t + half;   // this half's segment
    Bucket<T> bk = plan.b[0];
#pragma unroll
    for (int i = 1; i < MAX_BUCKETS; ++i)
      if (i < plan.nb && s >= plan.b[i].first) bk = plan.b[i];
    const bool live = s < plan.nseg;
    const long long ls = s - bk.first;  // the segment within its bucket
    const int w = live ? bk.w : 0;
    const T* sv = bk.vals + ls * bk.w;
    const int* sc = bk.cols + ls * bk.w;
    const long long row = live ? bk.rows[ls] : 0;
    // both halves run every loop below the same number of times, so each
    // shuffle and ballot has all 32 lanes
    const int wmax = max(w, __shfl_xor_sync(FULL, w, HALF));
    T o[NP][VEC], acc[NP][VEC];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = (HALF * p + hl) * VEC;
      if (live && c < r) {
        load_vec<T, VEC>(own + row * r + c, o[p]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[p][i] = T(0);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[p][i] = T(0);
    }
    bool any = false;
    for (int kb = 0; kb < wmax; kb += HALF) {
      const int k = kb + hl;
      const int my_col = k < w ? sc[k] : 0;
      const T my_val = k < w ? sv[k] : T(0);
      unsigned bits = (__ballot_sync(FULL, my_val != T(0)) >>
                       (HALF * half)) & 0xffffu;
      const int nk = __popc(bits);
      const int nmax = max(nk, __shfl_xor_sync(FULL, nk, HALF));
      any |= nk > 0;
      for (int j = 0; j < nmax; j += U) {
        // the next U nonzero lanes of this half, in k order
        int col[U];
        T val[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = bits ? __ffs(bits) - 1 : 0;
          bits &= bits - 1;
          col[u] = __shfl_sync(FULL, my_col, HALF * half + src);
          val[u] = __shfl_sync(FULL, my_val, HALF * half + src);
        }
        T x[U][NP][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* trow = table + static_cast<long long>(col[u]) * r;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int c = (HALF * p + hl) * VEC;
            if (j + u < nk && c < r) {
              load_vec<T, VEC>(trow + c, x[u][p]);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) x[u][p][i] = T(0);
            }
          }
        }
        // the samples: each lane's slice of the U dots, then a transposed
        // reduction over the half. At each of the first log2(U) xor steps
        // a lane keeps half of its partials and trades the other half with
        // its partner; plain butterfly steps follow. Lane hl then holds
        // the whole dot of row `mine` (its bits 3, 2, 1 read high to low
        // as log2(U) bits), divides once, and the half trades the U
        // coefficients back.
        T dot[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dot[u] = T(0);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              dot[u] = fma_t(o[p][i], x[u][p][i], dot[u]);
        }
#pragma unroll
        for (int step = 0; step < 4; ++step) {
          const int off = HALF >> (step + 1);   // 8, 4, 2, 1
          const int k = U >> step;              // partials before the step
          const bool up = (hl & off) != 0;
          if (k > 1) {
#pragma unroll
            for (int i = 0; i < k / 2; ++i) {
              const T send = up ? dot[i] : dot[i + k / 2];
              const T keep = up ? dot[i + k / 2] : dot[i];
              dot[i] = keep + __shfl_xor_sync(FULL, send, off);
            }
          } else {
            dot[0] += __shfl_xor_sync(FULL, dot[0], off);
          }
        }
        int mine = 0;
#pragma unroll
        for (int b = 0; b < LOG_U; ++b)
          mine = (mine << 1) | ((hl >> (3 - b)) & 1);
        T v_mine = val[0];
#pragma unroll
        for (int u = 1; u < U; ++u)
          if (u == mine) v_mine = val[u];
        const T c_mine = v_mine / (dot[0] + eps);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          int from = 0;                 // a lane that holds row u's dot
#pragma unroll
          for (int b = 0; b < LOG_U; ++b)
            from |= ((u >> (LOG_U - 1 - b)) & 1) << (3 - b);
          const T c = __shfl_sync(FULL, c_mine, HALF * half + from);
          if (j + u < nk) {
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                acc[p][i] = fma_t(c, x[u][p][i], acc[p][i]);
          }
        }
      }
    }
    if (!any) continue;                 // nothing to add: a pad segment
    T* so = out + row * r;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = (HALF * p + hl) * VEC;
      if (c < r) add_vec<T, VEC>(so + c, acc[p]);
    }
  }
}

// enough blocks for every SM several times over; the grid-stride walk
// takes the rest
int grid_size(long long nseg, unsigned* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = ((nseg + 1) / 2 + WARPS - 1) / WARPS;
  const long long cap = 32LL * sms;
  *grid = static_cast<unsigned>(want < cap ? want : cap);
  return 0;
}

template <typename T, int VEC, int NP>
int launch_t(const Plan<T>& plan, const T* table, T* out, int r,
             cudaStream_t stream) {
  unsigned grid = 0;
  if (const int err = grid_size(plan.nseg, &grid)) return err;
  ell_spmm_kernel<T, VEC, NP><<<grid, THREADS, 0, stream>>>(plan, table,
                                                            out, r);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// desc: nb rows of (vals, cols, rows, nseg, w), in launch order
template <typename T>
int read_plan(const long long* desc, int nb, int r, Plan<T>* plan) {
  if (nb < 1 || nb > MAX_BUCKETS || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *plan = Plan<T>{};
  long long first = 0;
  for (int i = 0; i < nb; ++i) {
    const long long* d = desc + 5 * i;
    plan->b[i] = Bucket<T>{reinterpret_cast<const T*>(d[0]),
                           reinterpret_cast<const int*>(d[1]),
                           reinterpret_cast<const int*>(d[2]), first,
                           static_cast<int>(d[4])};
    if (d[3] < 0 || d[4] < 1) return static_cast<int>(cudaErrorInvalidValue);
    first += d[3];
  }
  plan->nseg = first;
  plan->nb = nb;
  return 0;
}

// The widest vector a row can take: r a multiple of VEC and every row
// operand aligned to it.
template <typename T>
int widest_vec(int r, std::initializer_list<const void*> ptrs) {
  auto fits = [&](int vec) {
    const size_t bytes = vec * sizeof(T);
    if (bytes > 16 || r % vec != 0) return false;
    for (const void* p : ptrs)
      if (!aligned(p, bytes)) return false;
    return true;
  };
  return fits(4) ? 4 : fits(2) ? 2 : 1;
}

// The widest vector a row can take, then the fewest column groups that
// cover r in one pass (at most 4; wider rows take more passes).
template <typename T>
int launch(const long long* desc, int nb, const T* table, T* out, int r,
           cudaStream_t stream) {
  Plan<T> plan;
  if (const int err = read_plan(desc, nb, r, &plan)) return err;
  if (plan.nseg == 0) return 0;
  const int vec = widest_vec<T>(r, {table, out});
  const int np = r <= HALF * vec ? 1 : r <= 2 * HALF * vec ? 2 : 4;
#define NMFTPU_ELL_CASE(V, P)                                        \
  if (vec == V && np == P)                                           \
    return launch_t<T, V, P>(plan, table, out, r, stream);
  NMFTPU_ELL_CASE(1, 1) NMFTPU_ELL_CASE(1, 2) NMFTPU_ELL_CASE(1, 4)
  NMFTPU_ELL_CASE(2, 1) NMFTPU_ELL_CASE(2, 2) NMFTPU_ELL_CASE(2, 4)
  if constexpr (sizeof(T) == 4) {
    NMFTPU_ELL_CASE(4, 1) NMFTPU_ELL_CASE(4, 2) NMFTPU_ELL_CASE(4, 4)
  }
#undef NMFTPU_ELL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// #11's widest row: 64 bytes a lane in one pass
template <typename T>
constexpr int kl_max_rank() { return HALF * 64 / static_cast<int>(sizeof(T)); }

// The widest vector a row can take, then the fewest column groups (a
// power of two) that cover r in one pass; r beyond kl_max_rank is
// refused.
template <typename T>
int launch_kl(const long long* desc, int nb, const T* own, const T* table,
              T* out, int r, double eps, cudaStream_t stream) {
  Plan<T> plan;
  if (const int err = read_plan(desc, nb, r, &plan)) return err;
  if (r > kl_max_rank<T>()) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.nseg == 0) return 0;
  const int vec = widest_vec<T>(r, {own, table, out});
  int np = 1;
  while (HALF * vec * np < r) np *= 2;
  unsigned grid = 0;
  if (const int err = grid_size(plan.nseg, &grid)) return err;
#define NMFTPU_KL_CASE(V, P)                                              \
  if (vec == V && np == P) {                                              \
    ell_kl_kernel<T, V, P><<<grid, THREADS, 0, stream>>>(                 \
        plan, own, table, out, r, static_cast<T>(eps));                   \
    return static_cast<int>(cudaGetLastError());                          \
  }
  NMFTPU_KL_CASE(1, 1) NMFTPU_KL_CASE(1, 2) NMFTPU_KL_CASE(1, 4)
  NMFTPU_KL_CASE(1, 8) NMFTPU_KL_CASE(2, 1) NMFTPU_KL_CASE(2, 2)
  NMFTPU_KL_CASE(2, 4)
  if constexpr (sizeof(T) == 4) {
    NMFTPU_KL_CASE(1, 16) NMFTPU_KL_CASE(2, 8) NMFTPU_KL_CASE(4, 1)
    NMFTPU_KL_CASE(4, 2) NMFTPU_KL_CASE(4, 4)
  }
#undef NMFTPU_KL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface: desc (5 nb) int64 on the host, one row per bucket in launch
// order: the device addresses of its vals (nseg, w) of the entry's type,
// cols (nseg, w) int32 in [0, m) and rows (nseg,) int32 in [0, n), then
// nseg and w; table (m, r) and out (n, r) of the entry's type, out zeroed
// by the caller; all row-major and contiguous. Launches on `stream` (no
// launch when every bucket is empty) and returns cudaGetLastError() (0 =
// launched).
extern "C" {

int nmftpu_ell_spmm_f32(const long long* desc, int nb, const float* table,
                        float* out, int r, cudaStream_t stream) {
  return launch<float>(desc, nb, table, out, r, stream);
}

int nmftpu_ell_spmm_f64(const long long* desc, int nb, const double* table,
                        double* out, int r, cudaStream_t stream) {
  return launch<double>(desc, nb, table, out, r, stream);
}

// #11: desc as above; own (n, r) sampled by each segment's row, table (m,
// r) gathered by column, out (n, r) zeroed by the caller, all of the
// entry's type, row-major and contiguous; r <= 256 (float32) or 128
// (float64).
int nmftpu_ell_kl_f32(const long long* desc, int nb, const float* own,
                      const float* table, float* out, int r, double eps,
                      cudaStream_t stream) {
  return launch_kl<float>(desc, nb, own, table, out, r, eps, stream);
}

int nmftpu_ell_kl_f64(const long long* desc, int nb, const double* own,
                      const double* table, double* out, int r, double eps,
                      cudaStream_t stream) {
  return launch_kl<double>(desc, nb, own, table, out, r, eps, stream);
}

}  // extern "C"
