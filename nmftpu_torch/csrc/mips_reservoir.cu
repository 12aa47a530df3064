// Fused scoring + top-2-per-slot reservoir scan for top-k MIPS serving, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py).
//
// Replaces the TPU kernel nmftpu/kernels/mips_reservoir.py:135
// reservoir_topk_mips (its scan _reservoir_scan :90, pallas_call :107).
//
// For queries Wq (b, r) and the item table H (r, ldh), items [0, m): slot
// s of a reservoir of R slots sees items j * R + s, j = 0, 1, ...; for each
// (query, slot) the kernel keeps the best two (score, id) pairs under
// nmftpu's merge rule (mips_reservoir.py:79-83), strict '>' throughout, so
// a tie keeps the earlier, lower id. It writes the best to out[:, s] and
// the second to out[:, R + s] (scores float32, ids int32), as the TPU
// kernel's concatenate does. Slots that see no item keep (-inf, 0).
//
// Two designs, one per table type:
//
// bf16 and int8 tables: bf16 tensor cores (reservoir_tc_kernel). Scores
// are bf16-rounded queries times the exact table value: int8 values
// (|v| <= 127) and bf16 values are exact in bf16, so every product is
// exact in float32 and only the order of the float32 sums differs from
// the twin's k-ordered chain (mips_tile.cuh): scores agree to about
// sqrt(r) 2^-24 relative, ids may differ only at such near-ties. The
// certificate is unaffected: recommend_certified re-scores candidates in
// k order (retrieval/mips.py _gather_scores) and count_above.cu keeps its
// fmaf chain. A block of 256 threads (two warpgroups) owns 128 queries
// (64 a warpgroup, staged once as bf16, K-major) and 64 slots, and walks a
// range of tiles j in increasing order. Each table tile (r x 64) comes in
// by cp.async (16-, 8-, 4- or 1-byte copies with zero fill, so unaligned
// row strides such as m = 10,007 take the same kernel) into a ring of raw
// stages (4 for int8, 2 for bf16), and is converted to bf16 and
// transposed to K-major in shared memory by all threads; then each
// warpgroup issues wgmma m64n64k16 (float32 accumulators) over r. Up to
// r = 288 a tile comes in whole; above it (up to r = 832) the queries
// still stay whole in shared memory, but each tile comes in as equal
// chunks of its rank (tc_chunk), staged, converted and issued one after
// another into the tile's one accumulator (reservoir_tc_kernel<T, true>).
// The accumulators are double-buffered: while the tensor cores score tile
// t + 1, the CUDA cores fold tile t into the carry. The carry is three
// registers per (query, slot) in the accumulator's fragment layout: s1,
// s2 and both ids packed as 16-bit tile indices relative to the block's
// first tile (id = j R + s0 + col; the host keeps every block's range
// under 65,536 tiles). Columns beyond R or m score -inf.
// When the grid of (b / 128) x (R / 64) blocks fills at most half the SMs,
// the host splits the walk over j into as many ranges as one wave of
// blocks holds (tc_plan: b = 64 at R = 4096 takes 2), each block writes
// its range's candidates, and reservoir_merge_kernel folds the ranges in
// increasing order with the same rule. The one-pass result is the top two of each
// slot ordered by (score descending, id ascending), and folding a later
// range's best then second keeps that order, so the split result is
// identical.
//
// float32 tables: the CUDA-core tile of mips_tile.cuh (reservoir_kernel):
// a bf16 or TF32 product would round the table and break the precision
// contract, so it stays a float32 fmaf chain in k order. Block (x, y)
// owns queries [64 y, +64) and slots [64 x, +64).
//
// What bounds it on the H100: a scan costs 2·b·r·m flops, 2.75 TFLOP at
// b = 512, r = 256, m = 10,485,760: 2.78 ms on the bf16 tensor cores.
// The table is read once per 128-query block (4 times at b = 512, 2.7 GB
// each for int8), and the blocks of one slot range are launched next to
// each other so that they share each table tile through the 50 MB L2.
// The wgmma operands are read from shared memory (4 KB per 64 x 64 x 16
// product), which at n = 64 is the shared-memory bandwidth itself; the
// conversion and the carry fold run on the CUDA cores beside it.

#include "hopper_tc.cuh"
#include "mips_tile.cuh"

namespace {

using namespace nmftpu_mips;
using namespace nmftpu_tc;

template <typename T>
__global__ void __launch_bounds__(THREADS)
reservoir_kernel(const float* __restrict__ Wq, const T* __restrict__ H,
                 float* __restrict__ out_s, int* __restrict__ out_i, int b,
                 int r, int m, long long ldh, int R) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Hs = smem + static_cast<size_t>(padded_rank(r)) * LDQ;
  const int s0 = blockIdx.x * TS;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  stage_queries(Qs, Wq, b, r, q0);
  __syncthreads();

  float s1[TQ][TN], s2[TQ][TN];
  int i1[TQ][TN], i2[TQ][TN];
#pragma unroll
  for (int u = 0; u < TQ; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      s1[u][v] = s2[u][v] = -INFINITY;
      i1[u][v] = i2[u][v] = 0;
    }

  const int slot_cols = R - s0 < TS ? R - s0 : TS;
  for (long long c0 = s0; c0 < m; c0 += R) {   // tile j: c0 = j * R + s0
    const int ncols = m - c0 < slot_cols ? static_cast<int>(m - c0)
                                         : slot_cols;
    float acc[TQ][TN];
    score_tile(acc, Qs, Hs, H, ldh, r, c0, ncols);
#pragma unroll
    for (int u = 0; u < TQ; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int col = tx + 16 * v;
        const float s = col < ncols ? acc[u][v] : -INFINITY;
        const int gid = static_cast<int>(c0) + col;
        const bool beats1 = s > s1[u][v];
        i2[u][v] = beats1 ? i1[u][v] : (s > s2[u][v] ? gid : i2[u][v]);
        s2[u][v] = fmaxf(fminf(s, s1[u][v]), s2[u][v]);
        i1[u][v] = beats1 ? gid : i1[u][v];
        s1[u][v] = fmaxf(s, s1[u][v]);
      }
  }

  const long long ld_out = 2LL * R;
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int q = q0 + ty + 16 * u;
    if (q >= b) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int col = tx + 16 * v;
      if (col >= slot_cols) continue;
      const long long off = q * ld_out + s0 + col;
      out_s[off] = s1[u][v];
      out_i[off] = i1[u][v];
      out_s[off + R] = s2[u][v];
      out_i[off + R] = i2[u][v];
    }
  }
}

// ---- the tensor-core scan (bf16 and int8 tables) ---------------------------

constexpr int TC_THREADS = 256;   // two warpgroups
constexpr int TC_Q = 128;         // queries per block, 64 a warpgroup
constexpr int TC_S = 64;          // slots (table columns) per tile

template <typename T>
__host__ __device__ constexpr int raw_stages() {
  return sizeof(T) == 1 ? 4 : 2;
}

__host__ __device__ inline int tc_rank(int r) { return (r + 15) / 16 * 16; }

// Shared memory: the queries (TC_Q x rp bf16, 256 rp bytes) stay for the
// whole walk; two converted tiles (TC_S x kc bf16) and the raw ring (kc x
// TC_S values of T a stage) take 512 bytes per unit of kc, the depth of
// the rank chunk a step stages. Up to rp = TC_WHOLE_RANK a step stages
// the whole rank (kc = rp); above it, the rank is streamed in chunks of
// equal depth kc < rp, all accumulating into one tile's accumulator.
constexpr size_t TC_SMEM_MAX = 227 * 1024;   // a block's most, on the H100
constexpr int TC_WHOLE_RANK = 288;
constexpr int TC_MAX_RANK = 832;
static_assert(768 * TC_WHOLE_RANK <= TC_SMEM_MAX, "whole-rank tiles fit");
static_assert(256 * TC_MAX_RANK + 512 * 16 <= TC_SMEM_MAX,
              "16-deep chunks fit");

__host__ __device__ inline int tc_chunk(int rp) {
  const size_t left = TC_SMEM_MAX - 256 * static_cast<size_t>(rp);
  const int most = static_cast<int>(left / 512) / 16 * 16;
  const int chunks = (rp + most - 1) / most;
  return (rp + 16 * chunks - 1) / (16 * chunks) * 16;
}

template <typename T, bool CHUNKED>
size_t tc_smem_bytes(int r) {
  const size_t rp = tc_rank(r);
  const size_t kc = CHUNKED ? tc_chunk(static_cast<int>(rp)) : rp;
  return 2 * rp * TC_Q + 2 * (2 * kc * TC_S) +
         raw_stages<T>() * kc * TC_S * sizeof(T);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Qs (TC_Q rows, K = rp, bf16 K-major) = bf16(Wq[q0 + q, k]), zero for
// q0 + q >= b or k >= r. Thread e writes the 16 bytes at Qs + 16 e.
__device__ __forceinline__ void tc_stage_queries(uint8_t* Qs,
                                                 const float* __restrict__ Wq,
                                                 int b, int r, int rp,
                                                 int q0) {
  const int kc8 = rp / 8;
  for (int e = threadIdx.x; e < TC_Q * kc8; e += TC_THREADS) {
    const int q = q0 + (e >> 3) / kc8 * 8 + (e & 7);
    const int k = 8 * ((e >> 3) % kc8);
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = q < b && k + t < r ? Wq[static_cast<long long>(q) * r + k + t]
                                : 0.f;
    *reinterpret_cast<uint4*>(Qs + 16 * e) =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                   bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
  }
}

// The raw tile: rows k < r of items [c0, c0 + ncols) of H into raw
// (r x TC_S values, row-major), zero beyond ncols. Thread e copies the
// 16 bytes at raw + 16 e.
template <typename T>
__device__ __forceinline__ void tc_load_raw(uint8_t* raw,
                                            const T* __restrict__ H,
                                            long long ldh, int r,
                                            long long c0, int ncols, int g) {
  constexpr int PER = 16 / sizeof(T);          // values per copy
  constexpr int CPR = TC_S / PER;              // copies per row
  for (int e = threadIdx.x; e < r * CPR; e += TC_THREADS) {
    const int k = e / CPR;
    const int c = PER * (e % CPR);
    const int valid = min(max(ncols - c, 0), PER) * static_cast<int>(sizeof(T));
    const T* src = valid ? H + k * ldh + c0 + c : H;
    copy16(raw + 16 * e, reinterpret_cast<const int8_t*>(src), valid, g);
  }
}

// op (TC_S rows = items, depths [0, kd) of a tile kc deep, bf16 K-major)
// = raw transposed, as bf16; zero for k >= r. A unit is 4 items x 8
// depths; the item order is XOR-skewed by lane so that each 16-byte store
// of a warp's 8-lane phase hits its own banks.
template <typename T>
__device__ __forceinline__ void tc_convert(const uint8_t* raw, uint8_t* op,
                                           int r, int kd, int kc) {
  const int units = (TC_S / 4) * (kd / 8);
  for (int u = threadIdx.x; u < units; u += TC_THREADS) {
    const int uq = u % (TC_S / 4);
    const int k8 = u / (TC_S / 4);
    const int skew = (uq >> 1) & 3;
    if constexpr (sizeof(T) == 1) {
      // v -> bf16 without the quarter-rate conversion unit: the float
      // 2^23 + (v + 128) has the bits 0x4B0000uu with uu = v ^ 0x80;
      // subtracting 2^23 + 128 leaves v exactly, and as |v| <= 127 the
      // float's low 16 bits are zero, so its high half is bf16(v)
      uint32_t w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int k = 8 * k8 + t;
        w[t] = (k < r ? *reinterpret_cast<const uint32_t*>(
                            raw + k * TC_S + 4 * uq)
                      : 0u) ^ 0x80808080u;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int x = s ^ skew;
        uint32_t f[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          f[t] = __float_as_uint(
              __uint_as_float(__byte_perm(w[t], 0x4B000000u, 0x7650u | x)) -
              8388736.0f);
        *reinterpret_cast<uint4*>(op + cm_offset(4 * uq + x, 16 * k8, 2 * kc)) =
            make_uint4(__byte_perm(f[0], f[1], 0x7632),
                       __byte_perm(f[2], f[3], 0x7632),
                       __byte_perm(f[4], f[5], 0x7632),
                       __byte_perm(f[6], f[7], 0x7632));
      }
    } else {
      uint2 w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int k = 8 * k8 + t;
        w[t] = k < r ? *reinterpret_cast<const uint2*>(
                           raw + 2 * (k * TC_S + 4 * uq))
                     : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int x = s ^ skew;
        const uint32_t sel = (x & 1) ? 0x7632u : 0x5410u;
        uint32_t h[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) h[t] = (x & 2) ? w[t].y : w[t].x;
        *reinterpret_cast<uint4*>(op + cm_offset(4 * uq + x, 16 * k8, 2 * kc)) =
            make_uint4(__byte_perm(h[0], h[1], sel),
                       __byte_perm(h[2], h[3], sel),
                       __byte_perm(h[4], h[5], sel),
                       __byte_perm(h[6], h[7], sel));
      }
    }
  }
}

// Fold one scored tile (local index jl) into the carry, strict '>';
// columns at or beyond ncols score -inf (MASK: the tile is partial).
// ix holds i1 in its low half and i2 in its high half. A score changes
// the carry only if it beats s2, which after the first few hundred tiles
// is rare; so each group of 4 scores is tested first and updated only
// when one lane of the warp has a winner (a warp-uniform branch).
template <bool MASK>
__device__ __forceinline__ void tc_fold(const float (&acc)[32],
                                        float (&s1)[32], float (&s2)[32],
                                        uint32_t (&ix)[32], int ncols,
                                        uint32_t jl) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 4) {
    float s[4];
    bool hit = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      s[u] = !MASK || col < ncols ? acc[i] : -INFINITY;
      hit |= s[u] > s2[i];
    }
    if (!__any_sync(0xffffffffu, hit)) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      const uint32_t first = __byte_perm(ix[i], jl, 0x1054);   // (jl, i1)
      const uint32_t second = __byte_perm(ix[i], jl, 0x5410);  // (i1, jl)
      ix[i] = s[u] > s1[i] ? first : (s[u] > s2[i] ? second : ix[i]);
      s2[i] = fmaxf(fminf(s[u], s1[i]), s2[i]);
      s1[i] = fmaxf(s[u], s1[i]);
    }
  }
}

// Block (x, y, z): queries [128 x, +128), slots [64 y, +64), tiles
// [z tps, (z + 1) tps) of the walk; writes its candidates to
// out[(z b + q) 2R + slot] (the final output when z has one value).
// Step u stages chunk u % chunks of the rank of tile u / chunks.
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(TC_THREADS, 1)
reservoir_tc_kernel(const float* __restrict__ Wq, const T* __restrict__ H,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int b, int r, int m, long long ldh, int R, int tps,
                    int g) {
  constexpr int NR = raw_stages<T>();
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int rp = tc_rank(r);
  const int kc = CHUNKED ? tc_chunk(rp) : rp;
  const int chunks = CHUNKED ? (rp + kc - 1) / kc : 1;
  uint8_t* Qs = tc_smem;
  uint8_t* op = Qs + 2 * rp * TC_Q;              // two tiles
  uint8_t* raw = op + 2 * (2 * kc * TC_S);       // NR stages
  const size_t raw_bytes = static_cast<size_t>(kc) * TC_S * sizeof(T);
  const int q0 = blockIdx.x * TC_Q;
  const int s0 = blockIdx.y * TC_S;
  const int scols = min(TC_S, R - s0);
  const long long tiles = s0 < m ? (m - s0 + static_cast<long long>(R) - 1) / R
                                 : 0;
  const long long j0 = static_cast<long long>(blockIdx.z) * tps;
  const int nt = static_cast<int>(max(0LL, min(tiles - j0,
                                               static_cast<long long>(tps))));
  const int steps = nt * chunks;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  auto ncols = [&](int t) {
    const long long c0 = (j0 + t) * R + s0;
    return static_cast<int>(min(static_cast<long long>(scols), m - c0));
  };
  auto load_raw = [&](int u) {
    const int t = u / chunks, c = u - t * chunks;
    tc_load_raw<T>(raw + (u % NR) * raw_bytes,
                   H + static_cast<long long>(c) * kc * ldh, ldh,
                   min(kc, r - c * kc), (j0 + t) * R + s0, ncols(t), g);
  };
  // convert step u's raw tile into op[u & 1] and issue its products into
  // acc (on top of the tile's earlier chunks)
  auto advance = [&](float (&acc)[32], int u) {
    const int c = u % chunks;
    const int kd = min(kc, rp - c * kc);
    cp_async_wait<NR - 2>();
    __syncthreads();     // raw u is in; wgmma u - 2 is done everywhere
    uint8_t* tile = op + (u & 1) * (2 * kc * TC_S);
    tc_convert<T>(raw + (u % NR) * raw_bytes, tile, min(kc, r - c * kc), kd,
                  kc);
    fence_async_smem();
    __syncthreads();
    if (u + NR - 1 < steps) load_raw(u + NR - 1);
    cp_async_commit();
    wgmma_fence();
    if (c == 0) fence_regs(acc);
    const uint64_t dq =
        make_desc(smem_u32(Qs + wg * 64 * 2 * rp), 2 * rp) +
        (c * kc / 16) * DESC_STEP;
    const uint64_t dt = make_desc(smem_u32(tile), 2 * kc);
    for (int s = 0; s < kd / 16; ++s)
      wgmma_bf16_m64n64k16(acc, dq + s * DESC_STEP, dt + s * DESC_STEP,
                           c > 0 || s > 0);
    wgmma_commit();
  };

  float s1[32], s2[32], accA[32], accB[32];
  uint32_t ix[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s1[i] = s2[i] = -INFINITY;
    ix[i] = 0;
    accA[i] = accB[i] = 0.f;
  }

  tc_stage_queries(Qs, Wq, b, r, rp, q0);
#pragma unroll
  for (int u = 0; u < NR - 1; ++u) {
    if (u < steps) load_raw(u);
    cp_async_commit();
  }
  if (steps > 0) advance(accA, 0);

  // tile t's first chunk was issued into `cur`: issue its other chunks,
  // then tile t + 1's first into `nxt`, and fold `cur` while the tensor
  // cores score t + 1
  auto step = [&](float (&cur)[32], float (&nxt)[32], int t) {
    for (int c = 1; c < chunks; ++c) {
      advance(cur, t * chunks + c);
      wgmma_wait<1>();
    }
    if (t + 1 < nt) {
      advance(nxt, (t + 1) * chunks);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(cur);
    const int nc = ncols(t);
    if (nc == TC_S)
      tc_fold<false>(cur, s1, s2, ix, nc, static_cast<uint32_t>(t));
    else
      tc_fold<true>(cur, s1, s2, ix, nc, static_cast<uint32_t>(t));
  };
  for (int t = 0; t < nt; t += 2) {
    step(accA, accB, t);
    if (t + 1 < nt) step(accB, accA, t + 1);
  }
  cp_async_wait<0>();

  const long long ld_out = 2LL * R;
  const long long base = static_cast<long long>(blockIdx.z) * b;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int q = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (q >= b || col >= scols) continue;
    const long long off = (base + q) * ld_out + s0 + col;
    const long long id0 = s0 + col;
    out_s[off] = s1[i];
    out_i[off] = s1[i] == -INFINITY
                     ? 0 : static_cast<int>((j0 + (ix[i] & 0xffffu)) * R + id0);
    out_s[off + R] = s2[i];
    out_i[off + R] = s2[i] == -INFINITY
                         ? 0 : static_cast<int>((j0 + (ix[i] >> 16)) * R + id0);
  }
}

// out (b, 2R) = the ranges' candidates (splits, b, 2R) folded in range
// order: each range's best, then its second, by the scan's rule.
__global__ void reservoir_merge_kernel(const float* __restrict__ ps,
                                       const int* __restrict__ pi,
                                       float* __restrict__ out_s,
                                       int* __restrict__ out_i, int splits,
                                       int b, int R) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(b) * R) return;
  const long long ld = 2LL * R;
  const long long off = e / R * ld + e % R;
  float s1 = ps[off], s2 = ps[off + R];
  int i1 = pi[off], i2 = pi[off + R];
  for (int p = 1; p < splits; ++p) {
    const long long o = static_cast<long long>(p) * b * ld + off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = ps[o + h * R];
      const int id = pi[o + h * R];
      if (s > s1) {
        s2 = s1; i2 = i1; s1 = s; i1 = id;
      } else if (s > s2) {
        s2 = s; i2 = id;
      }
    }
  }
  out_s[off] = s1;
  out_i[off] = i1;
  out_s[off + R] = s2;
  out_i[off + R] = i2;
}

template <typename T>
int launch(const float* Wq, const T* H, float* out_s, int* out_i, int b,
           int r, int m, long long ldh, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      reservoir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TS - 1) / TS, (b + BQ - 1) / BQ);
  reservoir_kernel<T><<<grid, THREADS, smem, stream>>>(Wq, H, out_s, out_i,
                                                       b, r, m, ldh, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CHUNKED>
int launch_tc_as(const float* Wq, const T* H, float* out_s, int* out_i,
                 int b, int r, int m, long long ldh, int R, int tps,
                 int splits, int g, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<T, CHUNKED>(r);
  cudaError_t err = cudaFuncSetAttribute(
      reservoir_tc_kernel<T, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b + TC_Q - 1) / TC_Q,
                  static_cast<unsigned>((R + TC_S - 1) / TC_S), splits);
  reservoir_tc_kernel<T, CHUNKED><<<grid, TC_THREADS, smem, stream>>>(
      Wq, H, out_s, out_i, b, r, m, ldh, R, tps, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const float* Wq, const T* H, float* out_s, int* out_i, int b,
              int r, int m, long long ldh, int R, int tps, int splits,
              int g, cudaStream_t stream) {
  const long long ytiles = (R + TC_S - 1) / TC_S;
  if (r < 1 || r > TC_MAX_RANK || tps < 1 || tps > 65536 || splits < 1 ||
      splits > 65535 || ytiles > 65535 ||
      !(g == 16 || g == 8 || g == 4 || g == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_rank(r) <= TC_WHOLE_RANK
             ? launch_tc_as<T, false>(Wq, H, out_s, out_i, b, r, m, ldh, R,
                                      tps, splits, g, stream)
             : launch_tc_as<T, true>(Wq, H, out_s, out_i, b, r, m, ldh, R,
                                     tps, splits, g, stream);
}

}  // namespace

// C interface: Wq (b, r) float32; H (r, ldh) of the entry's type, items
// [0, m); out_s (b, 2R) float32 and out_i (b, 2R) int32 (the tensor-core
// entries: (splits, b, 2R), one block of candidates per range of
// `tiles_per_split` tiles, and g the alignment in bytes, 16, 8, 4 or 1,
// of every table row start they copy). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" {

int nmftpu_reservoir_scan_f32(const float* Wq, const float* H, float* out_s,
                              int* out_i, int b, int r, int m, long long ldh,
                              int R, cudaStream_t stream) {
  return launch<float>(Wq, H, out_s, out_i, b, r, m, ldh, R, stream);
}

int nmftpu_reservoir_scan_bf16(const float* Wq, const __nv_bfloat16* H,
                               float* out_s, int* out_i, int b, int r, int m,
                               long long ldh, int R, int tiles_per_split,
                               int splits, int g, cudaStream_t stream) {
  return launch_tc<__nv_bfloat16>(Wq, H, out_s, out_i, b, r, m, ldh, R,
                                  tiles_per_split, splits, g, stream);
}

int nmftpu_reservoir_scan_i8(const float* Wq, const int8_t* H, float* out_s,
                             int* out_i, int b, int r, int m, long long ldh,
                             int R, int tiles_per_split, int splits, int g,
                             cudaStream_t stream) {
  return launch_tc<int8_t>(Wq, H, out_s, out_i, b, r, m, ldh, R,
                           tiles_per_split, splits, g, stream);
}

// out (b, 2R) = the (splits, b, 2R) range candidates merged in order
int nmftpu_reservoir_merge(const float* part_s, const int* part_i,
                           float* out_s, int* out_i, int splits, int b,
                           int R, cudaStream_t stream) {
  const long long n = static_cast<long long>(b) * R;
  if (splits < 1 || (n + 255) / 256 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  reservoir_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                           stream>>>(part_s, part_i, out_s, out_i, splits, b,
                                     R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
