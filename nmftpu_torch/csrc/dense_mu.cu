// Fused Lee–Seung MU half-steps under the Frobenius objective, for Hopper
// (sm_90a), on the tensor cores in split tf32 ("3xTF32"), with a plain C
// interface loaded through ctypes (nmftpu_torch/kernels/_build.py).
//
//   W half-step:  W' = W ⊙ (s · V Hᵀ) / (W G + eps),  G = H Hᵀ  (r, r)
//   H half-step:  H' = H ⊙ (s · Wᵀ V) / (G H + eps),  G = Wᵀ W  (r, r)
//
// V is (n, m), W (n, r), H (r, m), all row-major and contiguous; W, H, G
// and the output are float32. The kernel is a template over V's element
// type: `float` with s = 1 (replaces nmftpu/kernels/dense_mu.py:277
// w_update_fused and :188 h_update_fused), and `int8_t` with the
// per-matrix scale s read from device memory (replaces
// nmftpu/kernels/quantized.py:148 w_update_fused_q and :70
// h_update_fused_q); s multiplies each numerator once in the epilogue.
//
// What bounds it on the H100. Each V element feeds 2r operations per
// half-step: 128 per byte for float32 V at r = 256, 512 for int8 V. On the
// CUDA cores (67 TFLOP/s) both are far above HBM's 3.35 TB/s, and the
// first version of this file, a float32 FMA loop, ran at 21 TFLOP/s. On
// the tensor cores the split below costs three tf32 products (two for
// int8 V) at 495 TFLOP/s: 0.055 ms (0.037) of product work at 4096² /
// r = 256 against 0.020 ms (0.005) of reading V. Operations bound still.
//
// Precision. A float32 operand x is split as hi = tf32(x) and
// lo = tf32(x - hi) (hopper_tc.cuh tf32_split) when its tile is staged;
// each product is hi·hi + hi·lo + lo·hi, whose dropped terms are below
// 2^-21 of it, with signs at random, so they add far less than the
// float32 sums' own rounding. int8 V is exact in tf32: V·hi + V·lo. The
// tensor cores' own float32 sums are another matter: if they truncate,
// as measurements of earlier tensor cores found, a chain of 1,536
// accumulations (K = 4096, three products per k8 step) drifts by about
// 3e-5, ten times float32's error. So the products of one stage (16 of
// depth, six wgmma) go to a fresh accumulator, which is added into the
// block's sum by a rounded float32 add: chains of six, then a rounded
// sum of K / 16 terms. tests/test_torch_kernels.py models both on the
// CPU against float64, and chip_smoke.py phases 3 and 5 hold every
// output against a float64 product (within 4x the plain float32 twin's
// error).
//
// Design. The H half-step is computed transposed, as H'ᵀ = Hᵀ ⊙ (Vᵀ W) /
// (Hᵀ G + eps), so both half-steps are one kernel: rows of the output
// product are V's rows (W step) or columns (H step), and the columns are
// all r factors up to 256 in one block (Cfg: two warpgroups of
// m64n128k8 over 64 rows, or for r <= 64 two of m64n64k8 over 128 rows,
// which halves the factor tile each block re-reads). So V is read from
// device memory once per half-step for r <= 256; a larger r takes 256
// factors a block, V once per 256 (the promoted sum needs two
// accumulators, and 2 x 64 registers a thread is what fits beside the
// rest). The depth walks in stages of 16: a 3-stage cp.async ring of
// raw tiles (16-, 8- or 4-byte copies with zero fill, so any row stride
// and ragged edge works), from which all threads split the next stage
// into tf32 hi/lo tiles, K-major in shared memory (transposing where the
// global layout is row-contiguous: V and W in the H step), while the
// tensor cores run the current one. wgmma takes tf32 only K-major, hence
// the transposes.
//
// What holds it back (chip_ablate.py, 4096² / r = 256): not the products
// nor the copies' latency (neither removing the products nor a deeper
// ring moves it much) but the CUDA-core work around them in each stage,
// the largest part the copying and splitting of the (256 x 16) factor
// tile, which every block repeats, and the wait for each stage's
// products before their promotion.
//
// Split depth. When the blocks fill less than about two waves of the
// card (4096² at r = 256: 64 blocks), and wherever a depth exceeds 8,192
// (the ML-20M shape: 138,493 in the H step, 26,744 in the W step), the
// wrapper splits it (kernels/dense_mu.py mu_splits): the promoted sum is
// a chain of at most 512 rounded adds, whose error stays below the
// plain float32 product's (a chain of 4,329 measured 3.2 times it).
// Every split writes its float32 partial numerator to a workspace; the
// last block of a tile to arrive (a counter in device memory) sums the
// partials in split order, so the result does not depend on which block
// finishes last: no float atomics. That block
// then computes the denominator (depth r) on the same split products and
// applies W ⊙ num · s / (den + eps), IEEE division, in the only store of
// the output, a buffer separate from W and H (other blocks read them).
// Offsets are 64-bit (n · m exceeds 2^31 at the ML-20M shape).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

using namespace nmftpu_tc;

constexpr int BK = 16;             // depth per stage: two k8 products
constexpr int KB = BK * 4;         // a stage's depth in bytes (tf32)
constexpr int KC_LD = BK + 4;      // padded raw row of a depth-contiguous
                                   // operand (80 bytes: no bank conflicts)
constexpr int THREADS = 256;       // two warpgroups
constexpr int NSTAGE = 3;          // raw tiles in the cp.async ring

// r <= 64 (narrow): the two warpgroups take 64 of the block's 128 rows
// each, all 64 factors (m64n64k8), two blocks an SM; else (wide): 64
// rows, and 128 of the block's 256 factors each (m64n128k8), one block an
// SM.
template <bool WIDE>
struct Cfg {
  static constexpr int BM = WIDE ? 64 : 128;      // rows a block
  static constexpr int WN = WIDE ? 128 : 64;      // columns a warpgroup
  static constexpr int NB = WIDE ? 256 : 64;      // columns a block
  static constexpr int PER_SM = WIDE ? 1 : 2;     // blocks an SM
  static constexpr int RAW_A = BM * KC_LD * 4;    // bytes of one raw tile
  static constexpr int RAW_B = NB * KC_LD * 4;
  static constexpr int OP_A = BM * KB;            // bytes of a hi or lo tile
  static constexpr int OP_B = NB * KB;
  static constexpr int RA = 0;                    // raw A ring
  static constexpr int RB = RA + NSTAGE * RAW_A;  // raw B ring
  static constexpr int OA = RB + NSTAGE * RAW_B;  // A [2 stages][hi, lo]
  static constexpr int OB = OA + 4 * OP_A;        // B [2 stages][hi, lo]
  static constexpr int FLAG = OB + 4 * OP_B;      // "this block is last"
  static constexpr int BYTES = FLAG + 16;
};

// An operand of the product D (rows x cols) = A · Bᵀ over depth k: its
// element (row, k) lies at p[row * ld + k] when it is depth-contiguous
// (KC), else at p[k * ld + row]. Rows at and beyond `rows` read as zero;
// the block's tile starts at row0; g is the copy size (16, 8, 4 or 1
// bytes) to which its row starts are aligned.
template <typename T>
struct Operand {
  const T* p;
  long long ld, rows, row0;
  int g;
};

__device__ __forceinline__ int copy_size(const void* p, long long ld_bytes) {
  const unsigned long long x =
      reinterpret_cast<unsigned long long>(p) |
      static_cast<unsigned long long>(ld_bytes);
  return (x & 15) == 0 ? 16 : (x & 7) == 0 ? 8 : (x & 3) == 0 ? 4 : 1;
}

template <typename T>
__device__ __forceinline__ Operand<T> operand(const T* p, long long ld,
                                              long long rows,
                                              long long row0) {
  return {p, ld, rows, row0,
          copy_size(p, ld * static_cast<long long>(sizeof(T)))};
}

// Copy depths [k0, k0 + BK) (zero at and beyond kend) of the ROWS rows of
// a tile into raw: float KC as [row][KC_LD], float MC as [k][ROWS], int8
// KC as [row][16 bytes], int8 MC as [k][ROWS bytes], in copies of G bytes
// (a compile-time constant, so each copy is one to four instructions).
// A thread's copies keep one column of 16 bytes and step through rows
// (KC) or depths (MC) by a fixed stride, so its source address is formed
// once and advanced.
template <int G, int ROWS, int NT, bool KC, typename T>
__device__ __forceinline__ void load_raw_g(uint8_t* raw, const Operand<T>& op,
                                           long long k0, long long kend,
                                           int tid) {
  constexpr int E = sizeof(T);
  constexpr int PER = 16 / E;                     // values a copy
  if constexpr (KC) {
    constexpr int CPR = BK / PER;                 // copies a row
    constexpr int LD = E == 4 ? KC_LD * 4 : 16;   // raw row, bytes
    constexpr int STEP = NT / CPR;                // rows a pass
    const int q = tid % CPR;
    const long long k = k0 + PER * q;
    const int kvalid = static_cast<int>(min(16LL, max(0LL, (kend - k) * E)));
    int row = tid / CPR;
    const T* src = op.p + (op.row0 + row) * op.ld + k;
#pragma unroll
    for (; row < ROWS; row += STEP, src += STEP * op.ld) {
      const int valid = op.row0 + row < op.rows ? kvalid : 0;
      copy16(raw + row * LD + 16 * q,
             reinterpret_cast<const int8_t*>(valid ? src : op.p), valid, G);
    }
  } else {
    constexpr int CPK = ROWS / PER;               // copies a depth
    constexpr int STEP = NT / CPK;                // depths a pass
    const int q = tid % CPK;
    const long long grow = op.row0 + PER * q;
    const int rvalid =
        static_cast<int>(min(16LL, max(0LL, (op.rows - grow) * E)));
    int k = tid / CPK;
    const T* src = op.p + (k0 + k) * op.ld + grow;
#pragma unroll
    for (; k < BK; k += STEP, src += STEP * op.ld) {
      const int valid = k0 + k < kend ? rvalid : 0;
      copy16(raw + (k * ROWS + PER * q) * E,
             reinterpret_cast<const int8_t*>(valid ? src : op.p), valid, G);
    }
  }
}

// load_raw_g for the operand's copy size, chosen once per tile
template <int ROWS, int NT, bool KC, typename T>
__device__ __forceinline__ void load_raw(uint8_t* raw, const Operand<T>& op,
                                         long long k0, long long kend,
                                         int tid) {
  if (op.g == 16)
    load_raw_g<16, ROWS, NT, KC>(raw, op, k0, kend, tid);
  else if (op.g == 8)
    load_raw_g<8, ROWS, NT, KC>(raw, op, k0, kend, tid);
  else if (sizeof(T) == 4 || op.g == 4)           // floats: 4 at least
    load_raw_g<4, ROWS, NT, KC>(raw, op, k0, kend, tid);
  else
    load_raw_g<1, ROWS, NT, KC>(raw, op, k0, kend, tid);
}

__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo,
                                            uint32_t off, float4 v) {
  float4 h, l;
  tf32_split(v.x, h.x, l.x);
  tf32_split(v.y, h.y, l.y);
  tf32_split(v.z, h.z, l.z);
  tf32_split(v.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

__device__ __forceinline__ float s8(uint32_t w, int b) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xFF));
}

// raw (load_raw's layout) -> the K-major hi and lo tiles (KB bytes deep);
// int8 values are exact in tf32 and go to hi alone. A unit is one row x
// 4 depths (16 bytes of a tile); consecutive threads take consecutive
// rows, so the 16-byte stores of a quarter-warp fill one core matrix.
template <int ROWS, int NT, bool KC, typename T>
__device__ __forceinline__ void convert_raw(const uint8_t* raw, uint8_t* hi,
                                            uint8_t* lo, int tid) {
  if constexpr (sizeof(T) == 4) {
    const float* rf = reinterpret_cast<const float*>(raw);
    for (int u = tid; u < ROWS * (BK / 4); u += NT) {
      const int row = u % ROWS, q = u / ROWS;
      float4 v;
      if constexpr (KC) {
        v = *reinterpret_cast<const float4*>(rf + row * KC_LD + 4 * q);
      } else {
        v = make_float4(rf[(4 * q) * ROWS + row], rf[(4 * q + 1) * ROWS + row],
                        rf[(4 * q + 2) * ROWS + row],
                        rf[(4 * q + 3) * ROWS + row]);
      }
      store_split(hi, lo, cm_offset(row, 16 * q, KB), v);
    }
  } else if constexpr (KC) {
    for (int row = tid; row < ROWS; row += NT) {
      const uint4 w = *reinterpret_cast<const uint4*>(raw + 16 * row);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(hi + cm_offset(row, 16 * q, KB)) =
            make_float4(s8(ws[q], 0), s8(ws[q], 1), s8(ws[q], 2),
                        s8(ws[q], 3));
    }
  } else {
    for (int u = tid; u < ROWS * (BK / 4); u += NT) {
      const int row = u % ROWS, q = u / ROWS;
      const int8_t* rb = reinterpret_cast<const int8_t*>(raw);
      *reinterpret_cast<float4*>(hi + cm_offset(row, 16 * q, KB)) =
          make_float4(rb[(4 * q) * ROWS + row], rb[(4 * q + 1) * ROWS + row],
                      rb[(4 * q + 2) * ROWS + row],
                      rb[(4 * q + 3) * ROWS + row]);
    }
  }
}

template <int WN>
__device__ __forceinline__ void mma(float (&d)[WN / 2], uint64_t da,
                                    uint64_t db, int accumulate) {
  if constexpr (WN == 64)
    wgmma_tf32_m64n64k8(d, da, db, accumulate);
  else
    wgmma_tf32_m64n128k8(d, da, db, accumulate);
}

// acc (this warpgroup's 64 x WN share of D = A · Bᵀ over depths
// [kbeg, kend)) by the split products; see the head of the file.
template <bool WIDE, bool A_KC, bool B_KC, typename TA>
__device__ void gemm3(float (&acc)[Cfg<WIDE>::WN / 2], uint8_t* smem,
                      const Operand<TA>& A, const Operand<float>& B,
                      long long kbeg, long long kend) {
  using C = Cfg<WIDE>;
  constexpr int WN = C::WN, NT = THREADS;
  constexpr bool SPLIT_A = sizeof(TA) == 4;       // int8 A needs no lo
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // this warpgroup's rows of the A tile and columns of the B tile
  const int a_off = WIDE ? 0 : wg * 64 * KB;
  const int b_off = WIDE ? wg * WN * KB : 0;
  const int tiles = static_cast<int>((kend - kbeg + BK - 1) / BK);
  uint8_t* raw_a = smem + C::RA;
  uint8_t* raw_b = smem + C::RB;
  auto op_a = [&](int b, int part) {
    return smem + C::OA + (2 * b + part) * C::OP_A;
  };
  auto op_b = [&](int b, int part) {
    return smem + C::OB + (2 * b + part) * C::OP_B;
  };
  auto load = [&](int t) {
    const long long k0 = kbeg + static_cast<long long>(t) * BK;
    const int s = t % NSTAGE;
    load_raw<C::BM, NT, A_KC>(raw_a + s * C::RAW_A, A, k0, kend, tid);
    load_raw<C::NB, NT, B_KC>(raw_b + s * C::RAW_B, B, k0, kend, tid);
  };
  auto convert = [&](int t) {
    const int s = t % NSTAGE, b = t & 1;
    convert_raw<C::BM, NT, A_KC, TA>(raw_a + s * C::RAW_A, op_a(b, 0),
                                     op_a(b, 1), tid);
    convert_raw<C::NB, NT, B_KC, float>(raw_b + s * C::RAW_B, op_b(b, 0),
                                        op_b(b, 1), tid);
  };

#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  float part[WN / 2];
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }
  cp_async_wait<NSTAGE - 2>();
  __syncthreads();
  convert(0);
  fence_async_smem();
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    // raw stage (t + NSTAGE - 1) % NSTAGE was last read by convert(t - 1),
    // two barriers ago
    if (t + NSTAGE - 1 < tiles) load(t + NSTAGE - 1);
    cp_async_commit();
    const int b = t & 1;
    const uint64_t dah = make_desc(smem_u32(op_a(b, 0) + a_off), KB);
    const uint64_t dal = make_desc(smem_u32(op_a(b, 1) + a_off), KB);
    const uint64_t dbh = make_desc(smem_u32(op_b(b, 0) + b_off), KB);
    const uint64_t dbl = make_desc(smem_u32(op_b(b, 1) + b_off), KB);
    wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t step = kk * DESC_STEP;
      // the small terms first, into a fresh accumulator
      if constexpr (SPLIT_A) mma<WN>(part, dal + step, dbh + step, kk > 0);
      mma<WN>(part, dah + step, dbl + step, SPLIT_A || kk > 0);
      mma<WN>(part, dah + step, dbh + step, 1);
    }
    wgmma_commit();
    if (t + 1 < tiles) {
      // stage t + 1's copies are in (this thread's; the barrier makes
      // them everyone's); its hi/lo tiles were last read by the products
      // of stage t - 1, done before the last barrier
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      convert(t + 1);
      fence_async_smem();
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] += part[i];
    __syncthreads();
  }
  cp_async_wait<0>();
}

// One half-step; see the head of the file. Block (x, y, z) owns output
// rows [BM x, +BM) of the (transposed, for the H step) product, factor
// columns [NB y, +NB) and depth split z of gridDim.z.
template <typename TV, bool HSTEP, bool WIDE>
__global__ void __launch_bounds__(THREADS, Cfg<WIDE>::PER_SM)
update_kernel(const TV* __restrict__ V, const float* __restrict__ scale,
              const float* __restrict__ W, const float* __restrict__ H,
              const float* __restrict__ G, float* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counters, int n,
              int m, int r, int tiles_per_split, float eps) {
  using C = Cfg<WIDE>;
  constexpr int WN = C::WN;
  extern __shared__ __align__(128) uint8_t smem[];
  const long long M = HSTEP ? m : n;       // rows of the product
  const long long K = HSTEP ? n : m;       // the numerator's depth
  const long long row0 = static_cast<long long>(blockIdx.x) * C::BM;
  const int col0 = blockIdx.y * C::NB;
  const int splits = gridDim.z;
  const long long kbeg =
      static_cast<long long>(blockIdx.z) * tiles_per_split * BK;
  const long long kend =
      min(K, kbeg + static_cast<long long>(tiles_per_split) * BK);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  float acc[WN / 2];
  if constexpr (HSTEP)     // A(j, k) = V[k, j], B(i, k) = W[k, i]
    gemm3<WIDE, false, false>(acc, smem, operand(V, m, m, row0),
                              operand(W, r, r, col0), kbeg, kend);
  else                     // A(i, k) = V[i, k], B(c, k) = H[c, k]
    gemm3<WIDE, true, true>(acc, smem, operand(V, m, n, row0),
                            operand(H, m, r, col0), kbeg, kend);

  // register i of this thread holds product row row_of(i), column col_of(i)
  auto row_of = [&](int i) {
    return row0 + (WIDE ? 0 : 64 * wg) + 16 * warp + lane / 4 +
           8 * ((i >> 1) & 1);
  };
  auto col_of = [&](int i) {
    return col0 + (WIDE ? wg * WN : 0) + 8 * (i >> 2) + 2 * (lane & 3) +
           (i & 1);
  };
  float* part = ws + static_cast<long long>(blockIdx.z) * M * r;
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) {
    const long long row = row_of(i);
    const int col = col_of(i);
    if (row < M && col < r) part[row * r + col] = acc[i];
  }
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem + C::FLAG);
  if (tid == 0) {
    int* counter = &counters[blockIdx.y * gridDim.x + blockIdx.x];
    *last = atomicAdd(counter, 1) == splits - 1;
    if (*last) *counter = 0;     // every split has arrived: ready for reuse
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the denominator, depth r: W G (A = W, B(c, k) = G[k, c]), or for the
  // H step Hᵀ G (A(j, k) = H[k, j], B(i, k) = G[i, k])
  if constexpr (HSTEP)
    gemm3<WIDE, false, true>(acc, smem, operand(H, m, m, row0),
                             operand(G, r, r, col0), 0, r);
  else
    gemm3<WIDE, true, false>(acc, smem, operand(W, r, n, row0),
                             operand(G, r, r, col0), 0, r);
  const float s = scale ? *scale : 1.f;
  const float* X = HSTEP ? H : W;
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) {
    const long long row = row_of(i);
    const int col = col_of(i);
    if (row >= M || col >= r) continue;
    float num = 0.f;                       // the partials in split order
    for (int z = 0; z < splits; ++z)
      num += __ldcg(ws + (z * M + row) * r + col);
    const long long off = HSTEP ? col * M + row : row * r + col;
    out[off] = X[off] * (num * s) / (acc[i] + eps);
  }
}

template <typename TV, bool HSTEP, bool WIDE>
int launch_cfg(const TV* V, const float* scale, const float* W,
               const float* H, const float* G, float* out, float* ws,
               int* counters, int n, int m, int r, int splits, int per,
               float eps, cudaStream_t stream) {
  using C = Cfg<WIDE>;
  const long long M = HSTEP ? m : n;
  const long long xblocks = (M + C::BM - 1) / C::BM;
  const long long yblocks = (r + C::NB - 1) / C::NB;
  if (xblocks >= (1LL << 31) || yblocks > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = update_kernel<TV, HSTEP, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(xblocks),
                  static_cast<unsigned>(yblocks),
                  static_cast<unsigned>(splits));
  kernel<<<grid, THREADS, C::BYTES, stream>>>(V, scale, W, H, G, out, ws,
                                              counters, n, m, r, per, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, bool HSTEP>
int launch(const TV* V, const float* scale, const float* W, const float* H,
           const float* G, float* out, float* ws, int* counters, int n,
           int m, int r, int splits, float eps, cudaStream_t stream) {
  if (n < 1 || m < 1 || r < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long K = HSTEP ? n : m;
  const long long tiles = (K + BK - 1) / BK;
  const long long per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits)   // an empty split
    return static_cast<int>(cudaErrorInvalidValue);
  return r <= 64
      ? launch_cfg<TV, HSTEP, false>(V, scale, W, H, G, out, ws, counters, n,
                                     m, r, splits, static_cast<int>(per),
                                     eps, stream)
      : launch_cfg<TV, HSTEP, true>(V, scale, W, H, G, out, ws, counters, n,
                                    m, r, splits, static_cast<int>(per), eps,
                                    stream);
}

}  // namespace

// C interface: every entry launches on `stream` and returns
// cudaGetLastError() (0 = launched). `scale` is a device pointer to one
// float (the int8 entries) or null (the float32 entries, s = 1). The depth
// (m for W, n for H) is walked in `splits` parts of equal whole stages
// (none empty); `ws` holds splits x rows x r float32 partials (rows = n
// for W, m for H) and `counters` one zeroed int per 64 rows and 256
// factors (128 rows and 64 factors when r <= 64), which the kernel leaves
// zero again.
extern "C" {

int nmftpu_w_update_f32(const float* V, const float* scale, const float* W,
                        const float* H, const float* G, float* out,
                        float* ws, int* counters, int n, int m, int r,
                        int splits, float eps, cudaStream_t stream) {
  return launch<float, false>(V, scale, W, H, G, out, ws, counters, n, m, r,
                              splits, eps, stream);
}

int nmftpu_h_update_f32(const float* V, const float* scale, const float* W,
                        const float* H, const float* G, float* out,
                        float* ws, int* counters, int n, int m, int r,
                        int splits, float eps, cudaStream_t stream) {
  return launch<float, true>(V, scale, W, H, G, out, ws, counters, n, m, r,
                             splits, eps, stream);
}

int nmftpu_w_update_i8(const int8_t* V, const float* scale, const float* W,
                       const float* H, const float* G, float* out,
                       float* ws, int* counters, int n, int m, int r,
                       int splits, float eps, cudaStream_t stream) {
  return launch<int8_t, false>(V, scale, W, H, G, out, ws, counters, n, m,
                               r, splits, eps, stream);
}

int nmftpu_h_update_i8(const int8_t* V, const float* scale, const float* W,
                       const float* H, const float* G, float* out,
                       float* ws, int* counters, int n, int m, int r,
                       int splits, float eps, cudaStream_t stream) {
  return launch<int8_t, true>(V, scale, W, H, G, out, ws, counters, n, m, r,
                              splits, eps, stream);
}

const char* nmftpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
