// int8 x int8 -> int32 MU numerators on Hopper's int8 tensor cores
// (sm_90a), with a plain C interface loaded through ctypes
// (nmftpu_torch/kernels/_build.py).
//
//   dual:   nw = Vq Hqᵀ (n, r) and nh = Wqᵀ Vq (r, m) from one stream of
//           V's tiles (replaces nmftpu/kernels/dual_numer.py:128
//           dual_numerators_int8, the Pallas kernel behind Jacobi MU with
//           use_pallas and int8 V);
//   vht:    nw alone, wtv: nh alone (replace the two int8 dot_generals of
//           nmftpu/linalg/dense.py:334 _rhs_vht_int8 and :344
//           _rhs_wtv_int8, which the Gauss–Seidel int8 path runs).
//
// Vq is (n, m), WqT = Wqᵀ (r, n), Hq (r, m), all int8, row-major and
// contiguous, any n, m, r; outputs are int32 and must be zero on entry
// (the kernel adds into them). Scales are applied by the caller.
//
// Arithmetic: wgmma.mma_async m64nNk32 .s32.s8.s8 on the tensor cores,
// int32 accumulators in registers, no .satfinite. Integer sums are exact
// and do not depend on order, so every entry equals the float64 twin and
// XLA bit for bit; like XLA's, a sum past 2^31 wraps modulo 2^32 (the
// tensor cores' integer sums and atomicAdd both wrap).
//
// What bounds it on the H100: each V element feeds 2r multiply-adds per
// numerator, so at r = 256 int8 V holds 1024 operations per byte, above
// the int8 tensor cores' 1,979 TOP/s over 3.35 TB/s (about 590):
// operations bound at 4096² / r = 256 (8.7 us for the dual). At the
// ML-20M shape (r = 64) it is bound by reading V's 3.70 GB once (1.11 ms).
//
// Work split. A block owns 64 factor rows [f0, f0 + 64) (r is padded with
// zero rows), 512 rows of V [i0, i0 + 512) and a range of V's columns,
// walked in chunks of 64 columns through a 4-stage cp.async ring: two
// chunks load ahead and one product group stays in flight. cp.async
// rather than TMA: one loader takes every row stride, including ML-20M's
// m = 26,744, which is 8 mod 16, and the ragged shapes, with 16-, 8-, 4-
// or 1-byte copies and zero fill. Per chunk, warpgroup w:
//   nw: D (64 factors x 256 rows) += Hq_chunk · V[256 w.., chunk]ᵀ
//       (m64n256k32, both operands K-major along the chunk's columns);
//       it stays in registers for the whole walk and is added into nw
//       once at the end;
//   nh: D (64 factors x 32 columns) = WqT[f0.., i0..] · V[i0.., chunk]
//       over the block's 512 rows (m64n32k32). 8-bit wgmma takes only
//       K-major operands, and this product contracts over V's rows, so
//       the chunk is transposed in shared memory first (4 x 4 byte blocks
//       with __byte_perm; an XOR skew of the rows read and the columns
//       written keeps the shared-memory reads conflict-free and the writes
//       2-way). Its 64 x 64 share of nh is added with int32 atomicAdd
//       (zeros skipped). So one read of V feeds both products.
// The nh product of a chunk is issued first and waited for before its
// share goes to nh; the nw product, issued after it, runs on while the
// CUDA cores add that share and transpose the next chunk.
//
// Reduction across blocks: nh is summed over the n / 512 row blocks, nw
// over the column ranges. The host splits m into the fewest ranges that
// fill whole waves of one block per SM to 90% (at the ML-20M shape, 271
// row blocks alone would make three waves, the last of 7 blocks).
// Atomics: at 4096² / r = 256, 8 row blocks x 256 x 4096 = 8.4M for nh
// plus 4 column ranges x 4096 x 256 = 4.2M for nw (50 MB, against 16.7 MB
// of V, which stays in the 50 MB L2 for the four factor blocks that share
// it); at the ML-20M shape, 271 x 64 x 26,744 = 464M for nh (1.86 GB,
// against 3.70 GB of V) plus 4 x 138,493 x 64 = 35M for nw. int32
// atomics are exact and order-free: the results stay deterministic.
//
// Offsets are 64-bit (n * m may exceed 2^31).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

using namespace nmftpu_tc;

constexpr int THREADS = 256;          // two warpgroups
constexpr int FB = 64;                // factor rows per block
constexpr int RB = 512;               // V rows per block, 256 a warpgroup
constexpr int BK = 64;                // V columns per chunk
constexpr int NS = 4;                 // chunk ring stages
constexpr int PF = NS - 2;            // chunks loaded ahead
constexpr int SMS = 132;

// Shared-memory carve-up, in bytes, for the products the entry computes.
template <bool NW, bool NH>
struct Layout {
  static constexpr int WT = 0;                          // WqT (FB x RB)
  static constexpr int VT = WT + (NH ? FB * RB : 0);    // chunkᵀ (BK x RB)
  static constexpr int V = VT + (NH ? BK * RB : 0);     // chunk (RB x BK)
  static constexpr int H = V + NS * RB * BK;            // Hq (FB x BK)
  static constexpr int BYTES = H + (NW ? NS * FB * BK : 0);
};

// Copy rows [row0, row0 + ROWS) (zero at and beyond nrows) and bytes
// [k0, k0 + KBYTES) (zero at and beyond kmax) of the row-major int8
// matrix p (row stride ld) into the K-major tile dst. Thread e writes the
// 16 bytes at dst + 16 e: consecutive threads fill one core matrix.
template <int ROWS, int KBYTES>
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* p,
                                          long long ld, long long row0,
                                          long long nrows, long long k0,
                                          long long kmax, int g) {
  constexpr int KC = KBYTES / 16;
  for (int e = threadIdx.x; e < ROWS * KC; e += THREADS) {
    const long long row = row0 + (e >> 3) / KC * 8 + (e & 7);
    const long long k = k0 + 16 * ((e >> 3) % KC);
    const int valid =
        row < nrows ? static_cast<int>(min(16LL, max(0LL, kmax - k))) : 0;
    copy16(dst + 16 * e, valid ? p + row * ld + k : p, valid, g);
  }
}

__device__ __forceinline__ void xor_permute(uint32_t (&a)[4], int x) {
  if (x & 1) {
    uint32_t t = a[0]; a[0] = a[1]; a[1] = t;
    t = a[2]; a[2] = a[3]; a[3] = t;
  }
  if (x & 2) {
    uint32_t t = a[0]; a[0] = a[2]; a[2] = t;
    t = a[1]; a[1] = a[3]; a[3] = t;
  }
}

// vt (BK rows = the chunk's columns, K = its RB rows) = the chunk v
// (RB rows, K = BK columns) transposed, in 4 x 4 byte blocks. Lane
// (rq, kc, cq) of warp w takes rows 8 g + 4 rq + [0, 4), g = w + 8 it, and
// columns 16 kc + 4 cq + [0, 4); it reads row t ^ kc at step t and writes
// column t ^ kc, so one read instruction of a warp touches 32 banks.
__device__ __forceinline__ void transpose_chunk(const uint8_t* v,
                                                uint8_t* vt) {
  const int lane = threadIdx.x & 31;
  const int cq = lane & 3, kc = (lane >> 2) & 3, rq = lane >> 4;
  const int col = 16 * kc + 4 * cq;
#pragma unroll 2
  for (int g = threadIdx.x >> 5; g < RB / 8; g += THREADS / 32) {
    const int i = 8 * g + 4 * rq;
    uint32_t a[4], c[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      a[t] = *reinterpret_cast<const uint32_t*>(
          v + cm_offset(i + (t ^ kc), col, BK));
    xor_permute(a, kc);                 // a[t]: row i + t
    const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
    const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
    const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
    const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
    c[0] = __byte_perm(lo01, lo23, 0x5410);
    c[1] = __byte_perm(lo01, lo23, 0x7632);
    c[2] = __byte_perm(hi01, hi23, 0x5410);
    c[3] = __byte_perm(hi01, hi23, 0x7632);
    xor_permute(c, kc);                 // c[t]: column col + (t ^ kc)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      *reinterpret_cast<uint32_t*>(vt + cm_offset(col + (t ^ kc), i, RB)) =
          c[t];
  }
}

template <bool NW, bool NH>
__global__ void __launch_bounds__(THREADS, 1)
int8_numer_kernel(const int8_t* __restrict__ V,
                  const int8_t* __restrict__ WqT,
                  const int8_t* __restrict__ Hq, int32_t* __restrict__ nw,
                  int32_t* __restrict__ nh, int n, int m, int r,
                  int chunks_per_block, int gv, int gw) {
  using L = Layout<NW, NH>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int f0 = blockIdx.x * FB;
  const long long i0 = static_cast<long long>(blockIdx.y) * RB;
  const long long c_begin =
      static_cast<long long>(blockIdx.z) * chunks_per_block * BK;
  if (c_begin >= m) return;
  const int nchunks = static_cast<int>(
      (min(static_cast<long long>(m), c_begin + chunks_per_block * BK) -
       c_begin + BK - 1) / BK);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  auto chunk_col = [&](int c) {
    return c_begin + static_cast<long long>(c) * BK;
  };
  auto load_chunk = [&](int c) {
    const long long c0 = chunk_col(c);
    load_tile<RB, BK>(smem + L::V + (c % NS) * RB * BK, V, m, i0, n, c0, m,
                      gv);
    if constexpr (NW)
      load_tile<FB, BK>(smem + L::H + (c % NS) * FB * BK, Hq, m, f0, r, c0,
                        m, gv);
  };

  if constexpr (NH)
    load_tile<FB, RB>(smem + L::WT, WqT, n, f0, r, i0, n, gw);
#pragma unroll
  for (int c = 0; c < PF; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }

  int accw[NW ? 128 : 1];
#pragma unroll
  for (int i = 0; i < (NW ? 128 : 1); ++i) accw[i] = 0;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<PF - 1>();
    fence_async_smem();
    // chunk c is in; every warpgroup's products of chunk c - 2 are done
    // (the wait at the end of the last step), so its stage may be refilled
    __syncthreads();
    if (c + PF < nchunks) load_chunk(c + PF);
    cp_async_commit();
    const uint8_t* v = smem + L::V + (c % NS) * RB * BK;
    int acch[NH ? 16 : 1];
    if constexpr (NH) {
      uint8_t* vt = smem + L::VT;
      transpose_chunk(v, vt);   // vt's last reader, nh of chunk c - 1, is done
      fence_async_smem();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i) acch[i] = 0;
      const uint64_t dw = make_desc(smem_u32(smem + L::WT), RB);
      const uint64_t dt = make_desc(smem_u32(vt + wg * 32 * RB), RB);
      wgmma_fence();
      fence_regs(acch);
#pragma unroll
      for (int s = 0; s < RB / 32; ++s)
        wgmma_s8_m64n32k32(acch, dw + s * DESC_STEP, dt + s * DESC_STEP,
                           s > 0);
      wgmma_commit();
    }
    if constexpr (NW) {
      const uint8_t* h = smem + L::H + (c % NS) * FB * BK;
      const uint64_t dh = make_desc(smem_u32(h), BK);
      const uint64_t dv = make_desc(smem_u32(v + wg * 256 * BK), BK);
      wgmma_fence();
      fence_regs(accw);
#pragma unroll
      for (int s = 0; s < BK / 32; ++s)
        wgmma_s8_m64n256k32(accw, dh + s * DESC_STEP, dv + s * DESC_STEP, 1);
      wgmma_commit();
    }
    if constexpr (NH) {
      // nh of chunk c is done; nw of chunk c (issued after it) runs on
      // while its share is added into nh
      wgmma_wait<NW ? 1 : 0>();
      fence_regs(acch);
      const long long c0 = chunk_col(c);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int f = f0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const long long col =
            c0 + 32 * wg + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (f < r && col < m && acch[i] != 0)
          atomicAdd(&nh[static_cast<long long>(f) * m + col], acch[i]);
      }
    } else {
      wgmma_wait<1>();   // nw of chunk c - 1 is done
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  if constexpr (NW) {
    fence_regs(accw);
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int f = f0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const long long row =
          i0 + 256 * wg + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (f < r && row < n && accw[i] != 0)
        atomicAdd(&nw[row * r + f], accw[i]);
    }
  }
}

template <bool NW, bool NH>
int launch(const int8_t* V, const int8_t* WqT, const int8_t* Hq, int32_t* nw,
           int32_t* nh, int n, int m, int r, int gv, int gw,
           cudaStream_t stream) {
  constexpr int smem = Layout<NW, NH>::BYTES;
  auto copy_size = [](int g) {
    return g == 16 || g == 8 || g == 4 || g == 1;
  };
  if (!copy_size(gv) || !copy_size(gw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_numer_kernel<NW, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fblocks = (r + FB - 1) / FB;
  const long long rblocks = (n + RB - 1) / RB;
  const long long chunks = (m + BK - 1) / BK;
  if (fblocks > 65535 || rblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // split V's columns into ranges so that the blocks fill whole waves of
  // one block per SM: the fewest ranges (each of >= 8 chunks) that use at
  // least 90% of the waves' slots, else the best share
  const long long base = fblocks * rblocks;
  long long splits = 1, per = chunks;
  double best = -1.0;
  for (long long s = 1; s <= (chunks >= 16 ? chunks / 8 : 1); ++s) {
    const long long p = (chunks + s - 1) / s, n_s = (chunks + p - 1) / p;
    const long long blocks = base * n_s;
    const double share =
        static_cast<double>(blocks) / (SMS * ((blocks + SMS - 1) / SMS));
    if (share > best + 1e-9) {
      best = share;
      splits = n_s;
      per = p;
    }
    if (best >= 0.9) break;
  }
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(fblocks),
                  static_cast<unsigned>(rblocks),
                  static_cast<unsigned>(splits));
  int8_numer_kernel<NW, NH><<<grid, THREADS, smem, stream>>>(
      V, WqT, Hq, nw, nh, n, m, r, static_cast<int>(per), gv, gw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every entry launches on `stream` and returns
// cudaGetLastError() (0 = launched). Outputs must be zero on entry. gv is
// the copy size (16, 8, 4 or 1 bytes) to which the row starts of V and Hq
// (stride m) are aligned, gw that of WqT's rows (stride n).
extern "C" {

// out (n, r) += Vq (n, m) · Hq (r, m)ᵀ
int nmftpu_int8_vht(const int8_t* V, const int8_t* Hq, int32_t* out, int n,
                    int m, int r, int gv, int gw, cudaStream_t stream) {
  return launch<true, false>(V, nullptr, Hq, out, nullptr, n, m, r, gv, gw,
                             stream);
}

// out (r, m) += WqT (r, n) · Vq (n, m)
int nmftpu_int8_wtv(const int8_t* V, const int8_t* WqT, int32_t* out, int n,
                    int m, int r, int gv, int gw, cudaStream_t stream) {
  return launch<false, true>(V, WqT, nullptr, nullptr, out, n, m, r, gv, gw,
                             stream);
}

// nw (n, r) += Vq Hqᵀ and nh (r, m) += WqT Vq, one read of V
int nmftpu_int8_dual(const int8_t* V, const int8_t* WqT, const int8_t* Hq,
                     int32_t* nw, int32_t* nh, int n, int m, int r, int gv,
                     int gw, cudaStream_t stream) {
  return launch<true, true>(V, WqT, Hq, nw, nh, n, m, r, gv, gw, stream);
}

}  // extern "C"
