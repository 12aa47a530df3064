// Fused scoring + count-above-threshold, the certificate's count pass of
// top-k serving, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (nmftpu_torch/kernels/_build.py).
//
// Replaces the TPU kernel nmftpu/kernels/count_above.py:95
// count_above_fused (its scan _count_scan :71, pallas_call :76).
//
// For queries Wq (b, r) (bf16-rounded, any (r,) int8 scale folded in by
// the wrapper), the item table H (r, ldh) (bf16 or int8) with items
// [0, m) and thresholds theta (b,): counts[q] += #{j < m : chain(q, j) >
// theta[q]}, where chain(q, j) is the float32 sum of the r products
// q[k] H[k, j] taken one by one in k order, acc = fmaf(q[k], H[k, j], acc)
// from acc = 0. That is the score retrieval/mips.py _gather_scores forms,
// and the certificate takes theta from such scores: the kth item must
// never count above itself, and no item just above theta may be missed.
// The wrapper zeroes `counts`; rows q >= b are masked here.
//
// Design: the products run on the bf16 tensor cores (wgmma m64n64k16,
// float32 accumulators), which sum in another order, and an exact band
// keeps the counts equal to the chain's.
//
// The band. Every product q[k] H[k, j] is exact in float32 (bf16 times
// bf16, or times an int8 value, has at most 16 significant bits), so the
// tensor-core score s and the chain sum the same r exact products and
// differ only by rounding. Let A = ||q||_1 h_max >= sum_k |q[k] H[k, j]|,
// with h_max >= max |H| (128 for int8, the table's max |H| for bf16).
// Every partial sum of either order is at most A in magnitude. The chain
// rounds r - 1 additions to nearest: at most (r - 1) 2^-24 A. The tensor
// cores may align the addends of a group to the largest exponent and
// truncate, and truncate each group's sum: allow each product and each
// group 1 ulp of a quantity <= A, at most 2 r 2^-23 A. So |s - chain| <=
// 2.5 r 2^-23 A; the wrapper takes tau = 4 r 2^-23 A + r 2^-125 (the
// last term for products and sums flushed below float32's normal range)
// and passes lo <= theta - tau and hi >= theta + tau, rounded outwards
// (kernels/count_above.py band_limits). Then s > hi proves chain > theta
// (count), s < lo proves chain < theta (no count), and a pair with
// lo <= s <= hi goes to a device list (pairs, nband) and is re-scored by
// the chain itself (count_band_kernel, one thread per pair). nband counts
// every band pair in 64 bits (one atomic per warp and accumulator), so it
// cannot wrap; a pair whose slot lies past the list's capacity is
// re-scored where it is found. No pair is dropped.
// theta = -inf counts every item and theta = +inf none: there lo and hi
// are infinite or the largest float, and no finite score lies between. A
// query whose bf16 row is all zero scores exactly 0 on every item in any
// order: the wrapper gives it lo = hi = -inf (theta < 0, every item
// counts) or +inf (none does), so its ties with theta = 0 never reach the
// band.
//
// Work split (count_tc_kernel). A block of 256 threads owns 128 queries
// (staged once, bf16, K-major in shared memory) and a range of
// consecutive 64-item tiles. Its two warpgroups walk alternate tiles in
// ping-pong: warpgroup w takes tiles w, w + 2, ... of the range, each with
// its own raw cp.async ring (3 stages for int8, 2 for bf16) and converted
// tile, and its own accumulators for both 64-query halves; it converts
// its tile to bf16 K-major, issues 2 x r / 16 wgmma and waits for them,
// then compares its 64 scores a thread with lo and hi: one max per row
// shows that almost every tile holds no score at or above any of the
// warp's lo, and only the rare warp that does runs the full compare and
// the band, out of line (ct_settle). No accumulator is
// read while a product is in flight (ptxas serializes that, note C7514),
// and while one warpgroup converts and compares, the other's products run.
// The warpgroups synchronize only with themselves (named barriers 1, 2).
// Ranks above what fits whole stream in equal chunks (count_tc_kernel<T,
// true>), as in mips_reservoir.cu. Columns >= m never count. Each thread
// keeps one count per query row it holds; the four lanes of a row reduce
// theirs by shuffles, and one atomicAdd per (query, warpgroup) adds them:
// integer sums are order-free, so the counts are deterministic.
//
// What bounds it on the H100: 2·b·r·m flops (2.75 TFLOP at b = 512,
// r = 256, m = 10,485,760): 2.78 ms on the bf16 tensor cores. The table
// is read once per 128-query block (4 times at b = 512); the blocks of
// one item range run side by side and share each tile through the 50 MB
// L2. At n = 64 both wgmma operands come from shared memory (8 KB per
// warpgroup step of 64 x 128 x 16), which with the conversion's traffic
// is about the shared-memory bandwidth of the tensor-core rate.

#include "mips_tile.cuh"
#include "tc_scan.cuh"

namespace {

using namespace nmftpu_tc;
using nmftpu_mips::table_value;

constexpr int CT_WGS = 2;         // warpgroups, each walking its own tiles
constexpr int CT_THREADS = 128 * CT_WGS;
constexpr int CT_Q = 128;         // queries per block: both halves, each wg
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr int ct_stages() {
  return sizeof(T) == 1 ? 3 : 2;
}

// Shared memory: the queries (256 rp bytes), then for each warpgroup its
// converted tile (TC_S x kc bf16) and its raw ring (ct_stages x kc x TC_S
// values of T). Bytes per unit of the chunk depth kc, both warpgroups:
template <typename T>
__host__ __device__ constexpr int ct_unit() {
  return CT_WGS *
         (2 * TC_S + ct_stages<T>() * TC_S * static_cast<int>(sizeof(T)));
}

// The depth a step stages: the whole padded rank when it fits, else the
// smallest number of equal 16-multiple chunks that fit.
template <typename T>
__host__ __device__ inline int ct_chunk(int rp) {
  const int left = static_cast<int>(TC_SMEM_MAX) - 2 * CT_Q * rp;
  const int most = left / ct_unit<T>() / 16 * 16;
  if (most >= rp) return rp;
  const int chunks = (rp + most - 1) / most;
  return (rp + 16 * chunks - 1) / (16 * chunks) * 16;
}

constexpr int CT_MAX_RANK = 832;
static_assert(2 * CT_Q * CT_MAX_RANK + 16 * ct_unit<__nv_bfloat16>() <=
                  static_cast<int>(TC_SMEM_MAX),
              "16-deep chunks fit");

template <typename T>
size_t ct_smem_bytes(int r) {
  const int rp = tc_rank(r);
  return static_cast<size_t>(2 * CT_Q * rp) +
         static_cast<size_t>(ct_unit<T>()) * ct_chunk<T>(rp);
}

// The chain: float32 fmaf in k order from 0 over bf16(q[k]) times the
// exact table value, the score retrieval/mips.py _gather_scores forms.
// Not inlined: the epilogue's 32 unrolled call sites share one body.
template <typename T>
__device__ __noinline__ float chain_score(const float* __restrict__ wq,
                             const T* __restrict__ H, long long ldh,
                             long long j, int r) {
  float acc = 0.f;
  for (int k = 0; k < r; ++k)
    acc = __fmaf_rn(__bfloat162float(__float2bfloat16_rn(wq[k])),
                    table_value(H[k * ldh + j]), acc);
  return acc;
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

struct Band {
  const float* Wq;
  const float* theta;
  int* pairs;
  unsigned long long* nband;
  unsigned long long cap;
  int r;
  long long ldh;
};

// Whether any score of the warp's (64 queries x 64 items) tile reaches its
// row's lo. Row x of the thread (x = 0, 1: rows lane / 4 and lane / 4 + 8
// of the warp's 16) holds accumulators i with (i >> 1) & 1 == x; columns
// at or beyond ncols do not exist (MASK). Warp-uniform.
template <bool MASK>
__device__ __forceinline__ bool ct_reaches(const float (&acc)[32],
                                           const float (&lo)[2], int ncols) {
  const int lane = threadIdx.x & 31;
  // most tiles hold no score near any of the warp's rows: the largest
  // score of each of the thread's two rows settles that in 32 max
  // operations, and only such a warp goes on to ct_settle
  float top[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int x = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    top[x] = fmaxf(top[x], !MASK || col < ncols ? acc[i] : -INFINITY);
  }
  return __any_sync(FULL, top[0] >= lo[0] || top[1] >= lo[1]);
}

// The rare tile that reaches some lo: scores above hi count, scores in
// [lo, hi] go through the band. Out of line, with the scores in s (a copy
// of the thread's accumulators), so that its code stays out of the walk's
// loop. Called by the whole warp. Returns the counts of rows x = 0, 1.
template <typename T>
__device__ __noinline__ int2 ct_settle(const float* s, float lo0, float lo1,
                                       float hi0, float hi1, int q0, int q1,
                                       long long item0, int ncols,
                                       const T* __restrict__ H, Band band) {
  const int lane = threadIdx.x & 31;
  int cnt[2] = {0, 0};
  bool near = false;
  for (int i = 0; i < 32; ++i) {
    const int x = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const bool ok = col < ncols;
    const bool above = ok && s[i] > (x ? hi1 : hi0);
    cnt[x] += above ? 1 : 0;
    near |= ok && !above && s[i] >= (x ? lo1 : lo0);
  }
  if (!__any_sync(FULL, near)) return make_int2(cnt[0], cnt[1]);
  for (int i = 0; i < 32; ++i) {
    const int x = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const bool mine = col < ncols && !(s[i] > (x ? hi1 : hi0)) &&
                      s[i] >= (x ? lo1 : lo0);
    // one atomic per warp and accumulator: the warp's band pairs take
    // consecutive slots of a 64-bit count, which no table can wrap
    const unsigned want = __ballot_sync(FULL, mine);
    if (want == 0) continue;
    const int leader = __ffs(want) - 1;
    unsigned long long base = 0;
    if (lane == leader)
      base = atomicAdd(band.nband,
                       static_cast<unsigned long long>(__popc(want)));
    base = __shfl_sync(FULL, base, leader);
    if (!mine) continue;
    const unsigned long long slot =
        base + static_cast<unsigned>(__popc(want & ((1u << lane) - 1)));
    const int q = x ? q1 : q0;
    const long long j = item0 + col;
    if (slot < band.cap) {
      band.pairs[2 * slot] = q;
      band.pairs[2 * slot + 1] = static_cast<int>(j);
    } else if (chain_score(band.Wq + static_cast<long long>(q) * band.r, H,
                           band.ldh, j, band.r) > band.theta[q]) {
      cnt[x] += 1;
    }
  }
  return make_int2(cnt[0], cnt[1]);
}

// Compare one scored tile (one 64-query half of the block) with its rows'
// limits, adding to the thread's counts of its two rows.
template <typename T>
__device__ __forceinline__ void ct_epilogue(const float (&acc)[32],
                                            const float (&lo)[2],
                                            const float (&hi)[2],
                                            int (&cnt)[2], const int (&qrow)[2],
                                            long long item0, int ncols,
                                            const T* __restrict__ H,
                                            const Band& band) {
  if (!(ncols == TC_S ? ct_reaches<false>(acc, lo, ncols)
                      : ct_reaches<true>(acc, lo, ncols)))
    return;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i];
  const int2 c = ct_settle<T>(s, lo[0], lo[1], hi[0], hi[1], qrow[0],
                              qrow[1], item0, ncols, H, band);
  cnt[0] += c.x;
  cnt[1] += c.y;
}

// Block (x, y): queries [128 x, +128), tiles [y tpb, (y + 1) tpb) of the
// ceil(m / 64) tiles. lim holds lo (b,), hi (b,), theta (b,).
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(CT_THREADS, 1)
count_tc_kernel(const float* __restrict__ Wq, const T* __restrict__ H,
                const float* __restrict__ lim, int* __restrict__ counts,
                int* __restrict__ pairs,
                unsigned long long* __restrict__ nband, int cap, int b,
                int r, int m, long long ldh, int tpb, int g) {
  constexpr int NR = ct_stages<T>();
  extern __shared__ __align__(128) uint8_t ct_smem[];
  const int rp = tc_rank(r);
  const int kc = CHUNKED ? ct_chunk<T>(rp) : rp;
  const int chunks = CHUNKED ? (rp + kc - 1) / kc : 1;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = threadIdx.x & 31;
  const size_t raw_bytes = static_cast<size_t>(kc) * TC_S * sizeof(T);
  uint8_t* Qs = ct_smem;
  uint8_t* op = Qs + 2 * CT_Q * rp +
                wg * (2 * kc * TC_S + NR * raw_bytes);   // this wg's tile
  uint8_t* raw = op + 2 * kc * TC_S;                      // its NR stages
  const int q0 = blockIdx.x * CT_Q;
  const long long tiles = (static_cast<long long>(m) + TC_S - 1) / TC_S;
  const long long t0 = static_cast<long long>(blockIdx.y) * tpb;
  const int ntb = static_cast<int>(
      max(0LL, min(tiles - t0, static_cast<long long>(tpb))));
  // this warpgroup's tiles: t0 + CT_WGS i + wg, i < nt
  const int nt = (ntb - wg + CT_WGS - 1) / CT_WGS;
  const int steps = nt * chunks;
  const Band band{Wq, lim + 2 * b, pairs, nband,
                  static_cast<unsigned long long>(cap), r, ldh};

  // thread rows: half h (queries 64 h + ...), x = 0, 1
  float lo[2][2], hi[2][2];
  int cnt[2][2] = {}, qrow[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = q0 + 64 * h + 16 * warp + lane / 4 + 8 * x;
      qrow[h][x] = q;
      lo[h][x] = q < b ? lim[q] : INFINITY;
      hi[h][x] = q < b ? lim[b + q] : INFINITY;
    }

  tc_stage_queries<CT_Q>(Qs, Wq, b, r, rp, q0, threadIdx.x, CT_THREADS);
  // each warpgroup's products read rows the other staged: fence every
  // thread's writes for the async proxy, then the only block-wide barrier
  fence_async_smem();
  __syncthreads();

  auto tile_of = [&](int i) { return t0 + CT_WGS * i + wg; };
  auto ncols = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(TC_S), m - t * TC_S));
  };
  auto load_raw = [&](int u) {
    const int i = u / chunks, c = u - i * chunks;
    const long long t = tile_of(i);
    tc_load_raw<T>(raw + (u % NR) * raw_bytes,
                   H + static_cast<long long>(c) * kc * ldh, ldh,
                   min(kc, r - c * kc), t * TC_S, ncols(t), g, tid, 128);
  };
#pragma unroll
  for (int u = 0; u < NR - 1; ++u) {
    if (u < steps) load_raw(u);
    cp_async_commit();
  }

  const uint64_t dq0 = make_desc(smem_u32(Qs), 2 * rp);
  const uint64_t dq1 = make_desc(smem_u32(Qs + 64 * 2 * rp), 2 * rp);
  const uint64_t dt = make_desc(smem_u32(op), 2 * kc);
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  for (int i = 0; i < nt; ++i) {
    for (int c = 0; c < chunks; ++c) {
      const int u = i * chunks + c;
      const int kd = min(kc, rp - c * kc);
      cp_async_wait<NR - 2>();
      wg_barrier(wg);    // raw u is in; this wg's products of u - 1 are done
      tc_convert<T>(raw + (u % NR) * raw_bytes, op, min(kc, r - c * kc), kd,
                    kc, tid, 128);
      fence_async_smem();
      wg_barrier(wg);
      if (u + NR - 1 < steps) load_raw(u + NR - 1);
      cp_async_commit();
      wgmma_fence();
      if (c == 0) {
        fence_regs(acc0);
        fence_regs(acc1);
      }
      const uint64_t step = static_cast<uint64_t>(c * kc / 16) * DESC_STEP;
      for (int s = 0; s < kd / 16; ++s) {
        wgmma_bf16_m64n64k16(acc0, dq0 + step + s * DESC_STEP,
                             dt + s * DESC_STEP, c > 0 || s > 0);
        wgmma_bf16_m64n64k16(acc1, dq1 + step + s * DESC_STEP,
                             dt + s * DESC_STEP, c > 0 || s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(acc0);
    fence_regs(acc1);
    const long long t = tile_of(i);
    const int nc = ncols(t);
    ct_epilogue<T>(acc0, lo[0], hi[0], cnt[0], qrow[0], t * TC_S, nc, H,
                   band);
    ct_epilogue<T>(acc1, lo[1], hi[1], cnt[1], qrow[1], t * TC_S, nc, H,
                   band);
  }
  cp_async_wait<0>();

  // the four lanes of a row (lane % 4) hold its columns: reduce, then one
  // atomic per (query, warpgroup)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      int v = cnt[h][x];
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      if ((lane & 3) == 0 && qrow[h][x] < b && v != 0)
        atomicAdd(&counts[qrow[h][x]], v);
    }
}

// The listed band pairs (q, j), min(*nband, cap) of them: re-score each by
// the chain and count it iff the chain exceeds theta[q].
template <typename T>
__global__ void count_band_kernel(const float* __restrict__ Wq,
                                  const T* __restrict__ H,
                                  const float* __restrict__ theta,
                                  const int* __restrict__ pairs,
                                  const unsigned long long* __restrict__ nband,
                                  int cap, int* __restrict__ counts, int r,
                                  long long ldh) {
  const int n = static_cast<int>(
      min(*nband, static_cast<unsigned long long>(cap)));
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const int q = pairs[2 * e];
    const int j = pairs[2 * e + 1];
    if (chain_score(Wq + static_cast<long long>(q) * r, H, ldh, j, r) >
        theta[q])
      atomicAdd(&counts[q], 1);
  }
}

template <typename T, bool CHUNKED>
int launch_as(const float* Wq, const T* H, const float* lim, int* counts,
              int* pairs, unsigned long long* nband, int cap, int b, int r,
              int m, long long ldh, int tpb, int g, cudaStream_t stream) {
  const size_t smem = ct_smem_bytes<T>(r);
  cudaError_t err = cudaFuncSetAttribute(
      count_tc_kernel<T, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (static_cast<long long>(m) + TC_S - 1) / TC_S;
  const dim3 grid((b + CT_Q - 1) / CT_Q,
                  static_cast<unsigned>((tiles + tpb - 1) / tpb));
  count_tc_kernel<T, CHUNKED><<<grid, CT_THREADS, smem, stream>>>(
      Wq, H, lim, counts, pairs, nband, cap, b, r, m, ldh, tpb, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (cap + 255LL) / 256;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  count_band_kernel<T><<<blocks, 256, 0, stream>>>(
      Wq, H, lim + 2 * b, pairs, nband, cap, counts, r, ldh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* Wq, const T* H, const float* lim, int* counts,
           int* pairs, unsigned long long* nband, int cap, int b, int r,
           int m, long long ldh, int tpb, int g, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(m) + TC_S - 1) / TC_S;
  if (b < 1 || r < 1 || r > CT_MAX_RANK || m < 1 || cap < 1 || tpb < 1 ||
      (tiles + tpb - 1) / tpb > 65535 ||
      !(g == 16 || g == 8 || g == 4 || g == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return ct_chunk<T>(tc_rank(r)) == tc_rank(r)
             ? launch_as<T, false>(Wq, H, lim, counts, pairs, nband, cap, b,
                                   r, m, ldh, tpb, g, stream)
             : launch_as<T, true>(Wq, H, lim, counts, pairs, nband, cap, b,
                                  r, m, ldh, tpb, g, stream);
}

}  // namespace

// C interface: Wq (b, r) float32; H (r, ldh) of the entry's type, items
// [0, m); lim (3 b) float32: lo, hi, theta; counts (b,) int32 and
// nband (1,) unsigned 64-bit, zeroed by the caller (nband ends as the
// number of band pairs); pairs (2 cap) int32 scratch;
// tiles_per_block of the 64-item tiles a block walks; g the alignment in
// bytes, 16, 8, 4 or 1, of every table row start. Launches the scan and
// the band re-score on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" {

int nmftpu_count_above_bf16(const float* Wq, const __nv_bfloat16* H,
                            const float* lim, int* counts, int* pairs,
                            unsigned long long* nband, int cap, int b, int r,
                            int m, long long ldh, int tiles_per_block, int g,
                            cudaStream_t stream) {
  return launch<__nv_bfloat16>(Wq, H, lim, counts, pairs, nband, cap, b, r,
                               m, ldh, tiles_per_block, g, stream);
}

int nmftpu_count_above_i8(const float* Wq, const int8_t* H, const float* lim,
                          int* counts, int* pairs, unsigned long long* nband,
                          int cap, int b, int r, int m, long long ldh,
                          int tiles_per_block, int g, cudaStream_t stream) {
  return launch<int8_t>(Wq, H, lim, counts, pairs, nband, cap, b, r, m, ldh,
                        tiles_per_block, g, stream);
}

}  // extern "C"
