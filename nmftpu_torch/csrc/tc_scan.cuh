// The staging and conversion steps shared by the two tensor-core scans of
// an item table (mips_reservoir.cu reservoir_tc_kernel, count_above.cu
// count_tc_kernel): bf16 queries staged once, K-major; table tiles of
// TC_S items copied raw by cp.async (16-, 8-, 4- or 1-byte copies with
// zero fill, so any row stride works), then converted to bf16 and
// transposed to K-major in shared memory, ready as a wgmma B operand.
// The layouts are hopper_tc.cuh's. Each helper takes the calling
// thread's index `tid` among the `nthreads` that share the work, so a
// whole block or one warpgroup can run it.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace nmftpu_tc {

constexpr int TC_S = 64;                     // items (table columns) a tile
constexpr size_t TC_SMEM_MAX = 227 * 1024;   // a block's most, on the H100

// the rank padded to the 16-deep bf16 product step
__host__ __device__ inline int tc_rank(int r) { return (r + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Qs (QROWS rows, K = rp, bf16 K-major) = bf16(Wq[q0 + q, k]), zero for
// q0 + q >= b or k >= r. Work item e writes the 16 bytes at Qs + 16 e.
template <int QROWS>
__device__ __forceinline__ void tc_stage_queries(uint8_t* Qs,
                                                 const float* __restrict__ Wq,
                                                 int b, int r, int rp, int q0,
                                                 int tid, int nthreads) {
  const int kc8 = rp / 8;
  for (int e = tid; e < QROWS * kc8; e += nthreads) {
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
// (r x TC_S values, row-major), zero beyond ncols. Work item e copies the
// 16 bytes at raw + 16 e.
template <typename T>
__device__ __forceinline__ void tc_load_raw(uint8_t* raw,
                                            const T* __restrict__ H,
                                            long long ldh, int r,
                                            long long c0, int ncols, int g,
                                            int tid, int nthreads) {
  constexpr int PER = 16 / sizeof(T);          // values per copy
  constexpr int CPR = TC_S / PER;              // copies per row
  for (int e = tid; e < r * CPR; e += nthreads) {
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
                                           int r, int kd, int kc, int tid,
                                           int nthreads) {
  const int units = (TC_S / 4) * (kd / 8);
  for (int u = tid; u < units; u += nthreads) {
    const int uq = u % (TC_S / 4);
    const int k8 = u / (TC_S / 4);
    const int skew = (uq >> 1) & 3;
    if constexpr (sizeof(T) == 1) {
      // v -> bf16 without the quarter-rate conversion unit: the float
      // 2^23 + (v + 128) has the bits 0x4B0000uu with uu = v ^ 0x80;
      // subtracting 2^23 + 128 leaves v exactly, and as |v| <= 128 the
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

}  // namespace nmftpu_tc
