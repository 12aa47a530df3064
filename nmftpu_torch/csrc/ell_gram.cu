// Per-row weighted Grams and right-hand sides of the iALS family on the
// ELL layout for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (nmftpu_torch/kernels/_build.py):
//
//     dG_i = sum_k w(v_ik) t_k t_k^T,   rhs_i = sum_k c(v_ik) t_k,
//
// t_k = table[col_k] (an (m, r) row-major float32 table, r <= 128), over
// row i's stored nonzeros, for one half-step. Two rules: iALS, w = alpha v
// and c = v (1 + alpha v); masked completion ALS, w = [v != 0] and c = v.
// Both vanish at v = 0, so pad lanes and stored zeros add nothing.
//
// Replaces no TPU kernel: nmftpu leaves this to XLA's gathers and einsums
// (nmftpu/sparse_ell.py:852 grams_and_rhs_ell). The port's plain path
// (sparse_ell.grams_and_rhs_ell off the card) gathers a (block, w, r) copy
// of the table rows, a weighted second copy, one bmm to a (block, r, r)
// result and index_add_ into a zeroed (n, r, r) buffer: four trips through
// HBM and about 950 launches a half-step at ML-20M clicks. Here each row's
// result is built in registers and written once.
//
// What bounds it on the H100: the lower triangles' FMAs, nnz r (r + 1) / 2
// a half-step (8.2e10 at ML-20M clicks' 9,990,682 nonzeros and r = 128,
// 2.5 ms at 67 TFLOP/s of float32), and the stores of every row's full
// symmetric Gram, n r^2 floats (136,677 rows: 8.96 GB, 2.7 ms at 3.35
// TB/s). The table rows' gathers come mostly from L2 (Ht, 10 MB, for the
// user half) or are 512-byte reads of whole rows.
//
// Work units. The wrapper deals each row's nonzeros into units of at most
// UNIT_MAX (kernels/ell_gram.py work_units): a unit is a run of one
// bucket's flat (values, columns) arrays, a segment or a slice of one,
// trimmed after its last nonzero value. Units run the longest and the
// shortest left in turn: the heaviest start first, and the blocks that
// mostly store run beside blocks that mostly compute. A row with one unit
// (nearly every user row)
// gets its result written directly; the units of a row with several write
// partial sums to a workspace slot each, and ell_gram_reduce_kernel adds a
// row's slots in slot order and writes the row: no float atomics, so equal
// inputs give bit-equal outputs. A row with no nonzeros has one empty unit,
// which writes zeros, so the outputs need no zero fill.
//
// A block of THREADS threads takes one unit. Thread t < TILES owns one 8
// x 4 tile (I, J) of the lower triangle of the R x R sum (R = 8 NT, r
// rounded up; rows 8I.., columns 4J.., J <= 2I + 1); a warp takes a 4 x 8
// block of tiles, so each of its three shared loads a row is one
// wavefront. The unit's columns, weights w and values c go to shared
// memory first. Its table rows then stream through a ring of RING stages
// of KT rows in shared memory by cp.async (16-byte copies where r % 4 ==
// 0, zero beyond r), two stages ahead. Each stage, every thread writes w
// times its share of the rows beside them and adds c times the same rows
// into its right-hand-side registers (summed over the stage rows at the
// end), then each tile takes three 16-byte shared loads and 32 FMAs a row.
// A stage's KT products are summed in registers of their own and then
// added to the row's totals, so a sum of 512 terms is 32 sums of 16 added
// in order: about the plain path's error (its batched products), where
// one chain of 512 FMAs was twice it. Float32 FMA on the CUDA cores
// throughout, no TF32. At r = 128: 272 tile threads in 9 warps, 96
// registers, 38.9 KB of shared memory, 2 blocks an SM. The epilogue
// writes a tile and its mirror (the tile transposed, assembled from
// registers) with 16-byte stores; a tile on the diagonal writes its
// entries on and below it and their mirrors.
//
// On an H100 at 700 W, ML-20M clicks at r = 128 (the benchmark's data):
// about 9.3 ms for the user half (137,611 units, 807 split rows) and 6.8
// ms for the item half (32,075 units, 2,996 split rows), 3.4 and 2.7 times
// the bound; the plain path takes 62.4 and 32.0 ms. The item half runs at
// about 25 TFLOP/s of the bound's operations, 37% of the float32 peak
// (about 41 instructions a row of a tile, 32 of them FMAs). The user
// half's stores cost it about 2 ms more than the same work without them
// (7.4 ms), the mirrors more than the direct tiles. Tried and no faster:
// one chain of 512 FMAs a 8 x 8 tile (160 threads, 3 blocks an SM,
// spilling; also twice the plain path's error); the same with its sums
// flushed to shared memory every 128 rows; a stage of 32 rows; the weight
// applied in registers with one barrier a stage; a ring of two stages;
// the right-hand side on threads of its own; streaming (evict-first)
// stores; the mirrors written by lane pairs so that each store fills whole
// sectors. Faster: the 4 x 8 warp blocks (row by row tiles took 10.6 and
// 7.0 ms) and the order of the units (longest first took 0.3 ms more on
// the user half).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

using nmftpu_tc::cp_async;
using nmftpu_tc::cp_async_commit;
using nmftpu_tc::cp_async_wait;
using nmftpu_tc::smem_u32;

constexpr int KT = 16;             // nonzeros a stage
constexpr int RING = 3;            // stages in shared memory
constexpr int UNIT_MAX = 512;      // kernels/ell_gram.py UNIT_NNZ
constexpr int MAX_NT = 16;         // r <= 8 * MAX_NT = 128

template <int NT>
struct Shape {
  static constexpr int R = 8 * NT;
  static constexpr int Q = R / 4;                      // float4 a stage row
  static constexpr int TILES = NT * (NT + 1);          // 8 x 4 tiles
  static constexpr int THREADS = (TILES + 31) / 32 * 32;
  static constexpr int LOADS = (KT * Q + THREADS - 1) / THREADS;
  static constexpr int MIN_BLOCKS = NT == MAX_NT ? 2 : 3;
};
// floats of one partial slot: 8 float4 for each thread of the widest
// block, then the right-hand side (kernels/ell_gram.py WS_SLOT_FLOATS)
constexpr long long WS_SLOT = 32 * 288 + 128;
static_assert(32 * Shape<MAX_NT>::THREADS + Shape<MAX_NT>::R == WS_SLOT,
              "a partial slot holds the widest block's totals");

// w (the Gram's weight) and c (the right-hand side's) of a stored value,
// in the plain path's float32 roundings: alpha * v, then v * (1 + alpha v)
__device__ __forceinline__ void rule_weights(int rule, float alpha, float v,
                                             float& w, float& c) {
  if (rule == 0) {
    w = __fmul_rn(alpha, v);
    c = __fmul_rn(v, __fadd_rn(1.f, w));
  } else {
    w = v != 0.f ? 1.f : 0.f;
    c = v;
  }
}

// The tile (I, J) of thread t; I = -1 for none. Where NT % 4 == 0 a
// warp takes a 4 x 8 block of tiles (rows 32 SI.., columns 32 SJ..): the
// blocks below the diagonal first, 32 tiles each, then the 20 tiles on
// and below the diagonal of each diagonal block, so a warp's three shared
// loads a row read 4, 4 and 8 consecutive float4, one wavefront each.
// Otherwise row block by row block (row block I holds 2I + 2 tiles).
template <int NT>
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = J = -1;
  if constexpr (NT % 4 == 0) {
    constexpr int NS = NT / 4, FULL = 32 * NS * (NS - 1) / 2;
    if (t < FULL) {
      const int f = t / 32, l = t % 32;
      int si = 1;
      while ((si + 1) * si / 2 <= f) ++si;
      I = 4 * si + l / 8;
      J = 8 * (f - si * (si - 1) / 2) + l % 8;
    } else if (t < FULL + 20 * NS) {
      const int d = t - FULL, s = d / 20, e = d % 20;
      const int a = e < 2 ? 0 : e < 6 ? 1 : e < 12 ? 2 : 3;
      I = 4 * s + a;
      J = 8 * s + e - a * (a + 1);
    }
  } else if (t < Shape<NT>::TILES) {
    I = 0;
    while ((I + 1) * (I + 2) <= t) ++I;
    J = t - I * (I + 1);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Write the tile (I, J) of one row's Gram G (r x r) and its mirror from
// the thread's totals, bounded by r.
__device__ __forceinline__ void write_tile(const float (&acc)[8][4], int I,
                                           int J, int r, bool vec4,
                                           float* __restrict__ G) {
  if (I < 0) return;
  if (J >= 2 * I) {
    // on the diagonal: entry (a, b), a >= b, and its mirror (b, a)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = 8 * I + i, b = 4 * J + j;
        if (a >= b && a < r) {
          G[static_cast<long long>(a) * r + b] = acc[i][j];
          G[static_cast<long long>(b) * r + a] = acc[i][j];
        }
      }
    return;
  }
  // rows 8I + i, columns 4J..4J+3
  const int c0 = 4 * J;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int a = 8 * I + i;
    if (a >= r) continue;
    float* dst = G + static_cast<long long>(a) * r + c0;
    if (vec4) {
      store4(dst, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < r) dst[j] = acc[i][j];
    }
  }
  // the mirror: rows 4J + j, columns 8I..8I+7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = c0 + j;
    if (b >= r) continue;
    float* dst = G + static_cast<long long>(b) * r + 8 * I;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (vec4) {
        if (8 * I + 4 * h < r)
          store4(dst + 4 * h, acc[4 * h][j], acc[4 * h + 1][j],
                 acc[4 * h + 2][j], acc[4 * h + 3][j]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * I + 4 * h + e < r) dst[4 * h + e] = acc[4 * h + e][j];
      }
    }
  }
}

// One block a unit: units[4u..4u+3] = (bucket, flat start, nonzeros <=
// UNIT_MAX, destination: the row, or -1 - its partial slot). buckets[2b],
// [2b+1]: the addresses of bucket b's float32 values and int32 columns.
template <int NT>
__global__ void __launch_bounds__(Shape<NT>::THREADS, Shape<NT>::MIN_BLOCKS)
    ell_gram_kernel(const long long* __restrict__ buckets,
                    const long long* __restrict__ units,
                    const float* __restrict__ table, int r, bool vec4,
                    int rule, float alpha, float* __restrict__ grams,
                    float* __restrict__ rhs, float* __restrict__ ws) {
  using S = Shape<NT>;
  __shared__ __align__(16) float4 raw[RING][KT * S::Q];
  __shared__ __align__(16) float4 wtd[KT * S::Q];
  __shared__ int scol[UNIT_MAX];
  __shared__ float sw[UNIT_MAX];
  __shared__ float sc[UNIT_MAX];

  const int t = threadIdx.x;
  const long long* unit = units + 4LL * blockIdx.x;
  const int len = static_cast<int>(unit[2]);
  const long long dst = unit[3];
  const int stages = (len + KT - 1) / KT;
  int I, J;
  tile_of<NT>(t, I, J);

  // the unit's columns, weights and values, zero past its end up to a
  // whole stage
  if (len > 0) {
    const int b = static_cast<int>(unit[0]);
    const float* vals = reinterpret_cast<const float*>(buckets[2 * b]) +
                        unit[1];
    const int* cols = reinterpret_cast<const int*>(buckets[2 * b + 1]) +
                      unit[1];
    for (int p = t; p < stages * KT; p += S::THREADS) {
      const float v = p < len ? __ldg(vals + p) : 0.f;
      float w, c;
      rule_weights(rule, alpha, v, w, c);
      scol[p] = p < len ? __ldg(cols + p) : 0;
      sw[p] = w;
      sc[p] = c;
    }
  }
  __syncthreads();

  // stage st's table rows into raw[buf]: float4 q = t + s THREADS holds
  // entries 4 (q % Q).. of the stage's row q / Q
  auto issue = [&](int st, int buf) {
#pragma unroll
    for (int s = 0; s < S::LOADS; ++s) {
      const int q = t + s * S::THREADS;
      if (q >= KT * S::Q) continue;
      const int p = st * KT + q / S::Q, c0 = 4 * (q % S::Q);
      const float* src = table + static_cast<long long>(scol[p]) * r + c0;
      const bool row = p < len;
      const uint32_t d = smem_u32(&raw[buf][q]);
      if (vec4) {
        const bool ok = row && c0 < r;
        cp_async<16>(d, ok ? src : table, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row && c0 + e < r;
          cp_async<4>(d + 4 * e, ok ? src + e : table, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // the right-hand side's sums over the stage rows and quads this thread
  // weights: slot s is row (t + s THREADS) / Q of every stage
  float4 rh[S::LOADS];
#pragma unroll
  for (int s = 0; s < S::LOADS; ++s) rh[s] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int st = 0; st < RING - 1; ++st)
    if (st < stages) issue(st, st);
  for (int st = 0; st < stages; ++st) {
    const int buf = st % RING;
    // stage st has landed when at most the later ones' copies are pending
    if (st + RING - 2 < stages)
      cp_async_wait<RING - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // stage st in raw[buf]; stage st - 1 summed by all
    if (st + RING - 1 < stages) issue(st + RING - 1, (st + RING - 1) % RING);
#pragma unroll
    for (int s = 0; s < S::LOADS; ++s) {
      const int q = t + s * S::THREADS;
      if (q < KT * S::Q) {
        const int p = st * KT + q / S::Q;
        const float w = sw[p], c = sc[p];
        const float4 x = raw[buf][q];
        wtd[q] = make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                             __fmul_rn(w, x.z), __fmul_rn(w, x.w));
        rh[s] = make_float4(fmaf(c, x.x, rh[s].x), fmaf(c, x.y, rh[s].y),
                            fmaf(c, x.z, rh[s].z), fmaf(c, x.w, rh[s].w));
      }
    }
    __syncthreads();
    if (I >= 0) {
      const float4* A = wtd + 2 * I;
      const float4* B = raw[buf] + J;
      float part[8][4];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float4 a0 = A[k * S::Q], a1 = A[k * S::Q + 1];
        const float4 b0 = B[k * S::Q];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = k == 0 ? __fmul_rn(a[i], b[j])
                                : fmaf(a[i], b[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
  }

  // the right-hand side: each stage row's sums (in wtd, free once every
  // thread is past the last stage), then added over the rows in order
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S::LOADS; ++s) {
    const int q = t + s * S::THREADS;
    if (q < KT * S::Q) wtd[q] = rh[s];
  }
  __syncthreads();
  float* rv = dst >= 0 ? rhs + dst * static_cast<long long>(r)
                       : ws + (-1 - dst) * WS_SLOT + 32 * S::THREADS;
  const float* red = reinterpret_cast<const float*>(wtd);
  for (int e = t; e < r; e += S::THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) sum += red[k * S::R + e];
    rv[e] = sum;
  }
  if (dst >= 0) {
    write_tile(acc, I, J, r, vec4,
               grams + dst * static_cast<long long>(r) * r);
  } else if (I >= 0) {
    // a partial slot: float4 e of thread t at e * THREADS + t
    float4* slot = reinterpret_cast<float4*>(ws + (-1 - dst) * WS_SLOT);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      slot[e * S::THREADS + t] =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
  }
}

// One block a split row: splits[3s..3s+2] = (row, first slot, slots); the
// row's slots added in slot order, then written as ell_gram_kernel writes
// a row of one unit.
template <int NT>
__global__ void __launch_bounds__(Shape<NT>::THREADS)
    ell_gram_reduce_kernel(const long long* __restrict__ splits,
                           const float* __restrict__ ws, int r, bool vec4,
                           float* __restrict__ grams,
                           float* __restrict__ rhs) {
  using S = Shape<NT>;
  const int t = threadIdx.x;
  int I, J;
  tile_of<NT>(t, I, J);
  const long long* split = splits + 3LL * blockIdx.x;
  const long long row = split[0], first = split[1], count = split[2];
  for (int e = t; e < r; e += S::THREADS) {
    float sum = 0.f;
    for (long long p = 0; p < count; ++p)
      sum += ws[(first + p) * WS_SLOT + 32 * S::THREADS + e];
    rhs[row * r + e] = sum;
  }
  if (I < 0) return;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long p = 0; p < count; ++p) {
    const float4* slot =
        reinterpret_cast<const float4*>(ws + (first + p) * WS_SLOT);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 y = __ldcs(slot + e * S::THREADS + t);
      acc[e][0] += y.x;
      acc[e][1] += y.y;
      acc[e][2] += y.z;
      acc[e][3] += y.w;
    }
  }
  write_tile(acc, I, J, r, vec4, grams + row * static_cast<long long>(r) * r);
}

// ---- host side -------------------------------------------------------------

template <int NT>
int launch_nt(const long long* buckets, const long long* units,
              long long n_units, const long long* splits, long long n_splits,
              const float* table, int r, float* grams, float* rhs, float* ws,
              int rule, float alpha, cudaStream_t stream) {
  using S = Shape<NT>;
  const bool vec4 = r % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(grams) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
  if (n_units > 0)
    ell_gram_kernel<NT><<<static_cast<unsigned>(n_units), S::THREADS, 0,
                          stream>>>(buckets, units, table, r, vec4, rule,
                                    alpha, grams, rhs, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return static_cast<int>(err);
  ell_gram_reduce_kernel<NT><<<static_cast<unsigned>(n_splits), S::THREADS,
                               0, stream>>>(splits, ws, r, vec4, grams, rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// #13: grams (n, r, r) and rhs (n, r), float32, every row's weighted Gram
// delta (full and symmetric) and right-hand side of one half-step, rule 0
// (iALS, w = alpha v, c = v (1 + alpha v)) or 1 (masked, w = [v != 0], c =
// v). buckets: pairs of addresses (values, columns); units (n_units, 4)
// and splits (n_splits, 3) int64 as kernels/ell_gram.py's work_units makes
// them, no unit over 512 nonzeros, every row of grams written by exactly
// one unit or split; ws: WS_SLOT floats for each partial slot; table (m,
// r) row-major; 1 <= r <= 128. Launches ell_gram_kernel on `stream`, then
// ell_gram_reduce_kernel if n_splits > 0, and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for what it cannot take.
int nmftpu_ell_gram_f32(const long long* buckets, const long long* units,
                        long long n_units, const long long* splits,
                        long long n_splits, const float* table, int r,
                        float* grams, float* rhs, float* ws, int rule,
                        float alpha, cudaStream_t stream) {
  if (r < 1 || r > 8 * MAX_NT || n_units < 0 || n_splits < 0 ||
      n_units > 0x7fffffffLL || n_splits > 0x7fffffffLL ||
      (rule != 0 && rule != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 16)
    return launch_nt<2>(buckets, units, n_units, splits, n_splits, table, r,
                        grams, rhs, ws, rule, alpha, stream);
  if (r <= 32)
    return launch_nt<4>(buckets, units, n_units, splits, n_splits, table, r,
                        grams, rhs, ws, rule, alpha, stream);
  if (r <= 64)
    return launch_nt<8>(buckets, units, n_units, splits, n_splits, table, r,
                        grams, rhs, ws, rule, alpha, stream);
  return launch_nt<16>(buckets, units, n_units, splits, n_splits, table, r,
                       grams, rhs, ws, rule, alpha, stream);
}

}  // extern "C"
